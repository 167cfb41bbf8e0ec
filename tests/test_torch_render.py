"""The port's room renderer: SyntheticBenchmark.render_uint8, which spreads
the ray casting over spawned processes (one BLAS thread each) and draws the
sensor noise in the parent, gives the bytes of iterating the sequence in one
process and casting each image to uint8, bit for bit, with and without the
photometric model. 70 frames make a pool of three processes where the host
has the cores."""
import numpy as np
import pytest

from lpslam_tpu_torch.io import SyntheticBenchmark

N_FRAMES = 70


@pytest.mark.parametrize("photometric", [True, False])
def test_render_uint8_equals_the_serial_render(photometric):
    def room():
        return SyntheticBenchmark(num_frames=N_FRAMES, h=60, w=80, seed=0,
                                  turns=1.08 * N_FRAMES / 600.0, photometric=photometric)

    serial = np.stack([f.image.astype(np.uint8) for f in room()])
    pooled = room().render_uint8()
    assert pooled.dtype == np.uint8 and pooled.shape == serial.shape
    assert np.array_equal(pooled, serial)


def test_render_uint8_refuses_stereo():
    with pytest.raises(ValueError):
        SyntheticBenchmark(num_frames=2, h=12, w=16, stereo=True).render_uint8()
