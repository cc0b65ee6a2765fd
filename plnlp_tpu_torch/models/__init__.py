from plnlp_tpu_torch.models.encoders import ENCODER_NAMES, Encoder
from plnlp_tpu_torch.models.predictors import PREDICTOR_NAMES, Predictor

__all__ = ["Encoder", "Predictor", "ENCODER_NAMES", "PREDICTOR_NAMES"]
