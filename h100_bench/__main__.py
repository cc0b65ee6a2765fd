"""``python -m h100_bench --workload <name> --seed <n> --seconds <s> --trace <0|1>``"""

import sys

from h100_bench.run import main

sys.exit(main())
