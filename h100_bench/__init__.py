"""The H100 benchmark of plnlp_tpu_torch: cells driven as data (see README.md)."""
