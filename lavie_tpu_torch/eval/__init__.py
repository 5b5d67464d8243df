"""The fork's evaluation harnesses (port of lavie_tpu.eval): CLIPSIM and FVD."""

from lavie_tpu_torch.eval.clipsim import CLIPSimilarityScorer
from lavie_tpu_torch.eval.fvd import compute_fvd, frechet_distance

__all__ = ["CLIPSimilarityScorer", "compute_fvd", "frechet_distance"]
