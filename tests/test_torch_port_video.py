"""The port's host video codec (lavie_tpu_torch.native, io/video.py) on the
CPU: an MJPEG .avi written and read back by the port, files written by the
JAX package (lavie_tpu.native) read by the port and the reverse, the grid
writer, and read_video's frame limit. The codec compiles csrc/mjpeg_avi.c
with the system C compiler against libjpeg at first use; without them
these tests skip, and write_video falls back to a GIF, as in the JAX
package.

Tolerance: MJPEG is lossy; the test videos are smooth waves, which the
writer's quality 95 keeps above 40 dB PSNR (seen: 46 dB); between the two
packages the bytes are the same codec's, so the frames are equal.
"""

import numpy as np
import pytest

from lavie_tpu_torch import native
from lavie_tpu_torch.io.video import read_video, save_video_grid, write_video


@pytest.fixture(scope="module", autouse=True)
def codec():
    if not native.mjpeg_available():
        pytest.skip("the MJPEG/AVI codec needs a C compiler (cc) and libjpeg, and found none")


def _video(seed, f=5, h=32, w=48):
    """Smooth frames: a wave per frame and channel, phases from the seed."""
    y, x = np.mgrid[0:h, 0:w]
    phase = np.random.RandomState(seed).rand(f, 1, 1, 3) * 6
    wave = np.sin(x[None, ..., None] / 7.0 + phase) * np.cos(y[None, ..., None] / 5.0)
    return np.clip(128 + 60 * wave, 0, 255).astype(np.uint8)


def _psnr(got, want):
    mse = ((got.astype(float) - want.astype(float)) ** 2).mean()
    return 10 * np.log10(255.0 ** 2 / mse)


def test_avi_round_trip(tmp_path):
    v = _video(400)
    path = write_video(str(tmp_path / "clip.mp4"), v, fps=12)
    assert path.endswith(".avi") or path.endswith(".mp4")  # mp4 where imageio has ffmpeg
    got = read_video(path)
    assert got.shape == v.shape and got.dtype == np.uint8
    assert _psnr(got, v) > 40.0
    native.write_avi(str(tmp_path / "direct.avi"), v, fps=12)
    assert native.probe_avi(str(tmp_path / "direct.avi")) == (5, 32, 48, 12)
    assert read_video(str(tmp_path / "direct.avi"), max_frames=3).shape == (3, 32, 48, 3)


def test_avi_files_cross_between_the_two_packages(tmp_path):
    from lavie_tpu import native as jax_native

    if not jax_native.mjpeg_available():
        pytest.skip("the JAX package's copy of the codec did not build")
    v = _video(401)
    jax_native.write_avi(str(tmp_path / "jax.avi"), v, fps=8)
    native.write_avi(str(tmp_path / "port.avi"), v, fps=8)
    np.testing.assert_array_equal(read_video(str(tmp_path / "jax.avi")),
                                  jax_native.read_avi(str(tmp_path / "jax.avi")))
    np.testing.assert_array_equal(jax_native.read_avi(str(tmp_path / "port.avi")),
                                  native.read_avi(str(tmp_path / "port.avi")))
    assert (tmp_path / "jax.avi").read_bytes() == (tmp_path / "port.avi").read_bytes()


def test_save_video_grid_tiles_row_by_row(tmp_path):
    videos = [_video(402 + i, f=4, h=16, w=24) for i in range(3)]
    path = save_video_grid(str(tmp_path / "grid.mp4"), videos, fps=8)
    grid = read_video(path)
    assert grid.shape == (4, 32, 48, 3)  # 2 x 2 cells, the fourth black
    for i, v in enumerate(videos):
        r, c = divmod(i, 2)
        assert _psnr(grid[:, r * 16:(r + 1) * 16, c * 24:(c + 1) * 24], v) > 30.0
    assert grid[:, 16:, 24:].mean() < 4.0
    with pytest.raises(ValueError):
        save_video_grid(str(tmp_path / "none.mp4"), [])
