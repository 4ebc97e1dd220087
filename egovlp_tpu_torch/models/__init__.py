from egovlp_tpu_torch.models.dual_encoder import (  # noqa: F401
    DualEncoder,
    DualEncoderConfig,
    sim_matrix,
)
from egovlp_tpu_torch.models.text_tower import DistilBert, TextTowerConfig  # noqa: F401
from egovlp_tpu_torch.models.video_tower import (  # noqa: F401
    SpaceTimeTransformer,
    VideoTowerConfig,
)
