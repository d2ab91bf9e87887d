"""Models of the port."""

from exoground_tpu_torch.models.aligner import TemporalAligner  # noqa: F401
