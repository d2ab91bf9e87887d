"""Host data layer of the port (counterpart of ``exoground_tpu/data``): the
HowTo100M, HTM-AA clip, EgoExo4D, LEMMA and YouCook2 readers, samplers, collate and the threaded
loader with pinned copies to the card."""

from exoground_tpu_torch.data.collate import (  # noqa: F401
    collate_dicts,
    pad_by_last,
    stack_features,
    stack_texts,
    stack_videos,
)
from exoground_tpu_torch.data.egoexo4d import (  # noqa: F401
    EgoExo4DDataset,
    EgoExo4DTANDataset,
    EgoExoConfig,
    EgoExoSource,
    camera_view_order,
)
from exoground_tpu_torch.data.htm import (  # noqa: F401
    HTMAlignDataset,
    HTMConfig,
    HTMFeatureDataset,
    read_vlen_csv,
)
from exoground_tpu_torch.data.io import FeatureStore, load_npy_window, load_pt  # noqa: F401
from exoground_tpu_torch.data.lemma import LemmaConfig, LemmaDataset  # noqa: F401
from exoground_tpu_torch.data.pipeline import (  # noqa: F401
    BackgroundIterator,
    ThreadedLoader,
    device_prefetch,
)
from exoground_tpu_torch.data.sampling import (  # noqa: F401
    CurriculumShardedSampler,
    ShardedSampler,
    batched,
    get_phase,
)
from exoground_tpu_torch.data.table import read_csv_records, write_csv_records  # noqa: F401
from exoground_tpu_torch.data.video_clips import (  # noqa: F401
    ClipConfig,
    HTMClipDataset,
    decode_clip,
    ffmpeg_available,
)
from exoground_tpu_torch.data.youcook2 import YouCook2Config, YouCook2Dataset  # noqa: F401
