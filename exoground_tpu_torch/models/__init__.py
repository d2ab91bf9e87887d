"""Models of the port."""

from exoground_tpu_torch.models.aligner import TemporalAligner  # noqa: F401
from exoground_tpu_torch.models.ema import ema_init, ema_update  # noqa: F401
from exoground_tpu_torch.models.grounding import (  # noqa: F401
    ExoGroundingTransformer,
    GroundingModel,
)
from exoground_tpu_torch.models.s3d import S3D, sentence_embedding_forward  # noqa: F401
from exoground_tpu_torch.models.word2vec import (  # noqa: F401
    Word2VecModel,
    Word2VecTokenizer,
    word2vec_forward,
)
