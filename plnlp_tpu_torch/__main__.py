"""``python -m plnlp_tpu_torch <flags of plnlp_tpu.cli>``: the training CLI
(``plnlp_tpu_torch.cli.main``)."""

from plnlp_tpu_torch.cli import main

if __name__ == "__main__":
    main()
