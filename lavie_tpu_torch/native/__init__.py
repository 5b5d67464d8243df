"""Host-side native code of the port: the MJPEG/AVI video codec
(csrc/mjpeg_avi.c at the repository root), bound with ctypes."""

from lavie_tpu_torch.native.mjpeg import (
    is_available as mjpeg_available,
    probe_avi,
    read_avi,
    write_avi,
)

__all__ = ["mjpeg_available", "probe_avi", "read_avi", "write_avi"]
