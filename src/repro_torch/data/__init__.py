"""The port's data stream (the counterpart of ``repro/data``)."""

from repro_torch.data.pipeline import DataConfig, SyntheticStream, make_batch

__all__ = ["DataConfig", "SyntheticStream", "make_batch"]
