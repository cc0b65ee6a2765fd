from plnlp_tpu_torch.data.synthetic import make_synthetic_dataset

__all__ = ["make_synthetic_dataset"]
