from lavie_tpu_torch.core.mesh import make_mesh, shard_batch_frames

__all__ = ["make_mesh", "shard_batch_frames"]
