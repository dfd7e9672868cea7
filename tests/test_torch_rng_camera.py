"""The port's TEA generator and camera against the JAX package.

TEA draws and pixel seeds are integer hashes: bit-exact, including a draw
whose float(v0) / 2^32 rounds up to exactly 1.0 (rng.py:50-51).  Camera
matrices are host numpy in both packages and primary rays are the same
float32 broadcasts, held within 1e-6.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from royaltracer_dx_tpu import camera as jcam
from royaltracer_dx_tpu.utils import rng as jrng

from royaltracer_dx_tpu_torch import camera as tcam
from royaltracer_dx_tpu_torch.utils import rng as trng

_M = 0xFFFFFFFF
_DELTA = 0x9E3779B9
_K = (0xA341316C, 0xC8013EA4, 0xAD90777D, 0x7E95761E)


def _untea(v0, v1):
    """Inverse of the 4 TEA rounds on Python ints: the seed whose draw
    ends in (v0, v1)."""
    sums = [(_DELTA * (i + 1)) & _M for i in range(4)]
    for s in reversed(sums):
        v1 = (v1 - ((((v0 << 4) + _K[2]) & _M) ^ ((v0 + s) & _M)
                    ^ (((v0 >> 5) + _K[3]) & _M))) & _M
        v0 = (v0 - ((((v1 << 4) + _K[0]) & _M) ^ ((v1 + s) & _M)
                    ^ (((v1 >> 5) + _K[1]) & _M))) & _M
    return v0, v1


def seeds(n, seed=1):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32)
    # the last two seeds draw v0 = 2^32 - 1 and 2^32 - 100: both round
    # to u == 1.0 in float32
    s[-1] = _untea(0xFFFFFFFF, 12345)
    s[-2] = _untea(0xFFFFFF9C, 777)
    return s


def as_port(s):
    return torch.as_tensor(s.astype(np.int64))


def test_tea_random_bit_exact_including_one():
    s = seeds(512)
    ju, js = jrng.tea_random(jnp.asarray(s))
    tu, ts = trng.tea_random(as_port(s))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    assert tu[-1] == 1.0 and tu[-2] == 1.0


@pytest.mark.parametrize("n", [1, 6, 18])
def test_tea_batches_bit_exact(n):
    s = seeds(300, seed=n)
    ju, js = jrng.tea_batch(jnp.asarray(s), n)
    tu, ts = trng.tea_batch(as_port(s), n)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    ju, _ = jrng.tea_batch_major(jnp.asarray(s), n)
    tu, _ = trng.tea_batch_major(as_port(s), n)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    for i in range(n):
        np.testing.assert_array_equal(
            trng.tea_batch_at(as_port(s), i).numpy(),
            np.asarray(jrng.tea_batch_at(jnp.asarray(s), i)))


@pytest.mark.parametrize("stream,time", [(1, 0), (2, 7), (3, 4294967295)])
def test_pixel_seed_bit_exact(stream, time):
    ys, xs = np.meshgrid(np.arange(37), np.arange(53), indexing="ij")
    xs, ys = xs.ravel().astype(np.int32), ys.ravel().astype(np.int32)
    js = jrng.pixel_seed(jnp.asarray(xs), jnp.asarray(ys), stream,
                         jnp.uint32(time))
    ts = trng.pixel_seed(torch.as_tensor(xs), torch.as_tensor(ys), stream,
                         time)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))


CAMS = [dict(eye=(0.5, 0.5, 1.72), center=(0.5, 0.5, 0.0)),
        dict(eye=(2.2, 1.6, 2.2), center=(0.5, 0.5, 0.5)),
        dict(eye=(-1.5, 1.5, 3.5), center=(0.0, 1.0, 0.0), fov_y_deg=45.0)]


@pytest.mark.parametrize("kw", CAMS)
def test_camera_matrices_and_rays(kw):
    jc, tc = jcam.Camera(**kw), tcam.Camera(**kw)
    jm, tm = jc.matrices(40 / 24), tc.matrices(40 / 24)
    for k in ("view", "proj", "view_inv", "proj_inv"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-6, atol=1e-6)
    jo, jd = jcam.generate_rays({k: jnp.asarray(v) for k, v in jm.items()},
                                40, 24)
    to, td = tcam.generate_rays({k: torch.as_tensor(v) for k, v in
                                 tm.items()}, 40, 24)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    jo2 = jc.orbited(0.03, -0.01)
    to2 = tc.orbited(0.03, -0.01)
    np.testing.assert_allclose(to2.eye, jo2.eye, atol=1e-6)


def test_kernel_constants_equal_the_plain_form():
    """csrc/tea_rng.cu's DELTA, K0..K3 and counter words are the plain
    form's, read from the source text."""
    src = os.path.join(os.path.dirname(trng.__file__), os.pardir, "csrc",
                       "tea_rng.cu")
    with open(src) as f:
        found = dict(re.findall(r"constexpr unsigned (\w+) = (0x[0-9A-F]+)u;",
                                f.read()))
    want = {k: getattr(trng, f"_{k}") for k in
            ("DELTA", "K0", "K1", "K2", "K3", "CTR_X", "CTR_Y")}
    assert {k: int(v, 16) for k, v in found.items()} == want


def test_cpu_draws_launch_no_kernel():
    """CPU tensors take the plain form: rng.LAUNCHES stays where it was
    (at 0 in a process without a card)."""
    before = dict(trng.LAUNCHES)
    s = as_port(seeds(64))
    trng.tea_random(s)
    trng.tea_randoms(s, 2)
    trng.tea_batch(s, 3)
    trng.tea_batch_major(s, 3)
    trng.tea_batch_at(s, 5)
    assert trng.LAUNCHES == before
    if not torch.cuda.is_available():
        assert trng.LAUNCHES == {"tea": 0}
