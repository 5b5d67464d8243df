from lavie_tpu_torch.pipelines.t2v import TextToVideoPipeline
from lavie_tpu_torch.pipelines.interpolate import VideoInterpolationPipeline
from lavie_tpu_torch.pipelines.vsr import VideoSuperResolutionPipeline
from lavie_tpu_torch.pipelines.cascade import VideoCascadePipeline

__all__ = [
    "TextToVideoPipeline",
    "VideoInterpolationPipeline",
    "VideoSuperResolutionPipeline",
    "VideoCascadePipeline",
]
