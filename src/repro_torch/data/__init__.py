from repro_torch.data.pipeline import SyntheticLMStream, make_calibration_batch

__all__ = ["SyntheticLMStream", "make_calibration_batch"]
