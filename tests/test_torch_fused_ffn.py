"""The port's fused FFN + LayerNorm (m3p_tpu_torch.ops.fused_ffn) on the CPU,
where its plain version runs, against the Pallas kernel of the JAX package.

The Pallas `fused_ffn_ln` has no ``interpret`` argument, but
`pltpu.force_tpu_interpret_mode()` runs its `pallas_call` on the CPU, row
tile, ragged last tile and all; nothing in the JAX package changes for it.
Both sides take the same numpy arrays (rounded to bf16 by both the same
way).  Tolerances: fp32 max abs 1e-5 (the two products sum in another
order; measured 9.5e-7); bf16 max abs 1.6e-2 (one bf16 ulp at |out| < 4,
where a sum that lands near a rounding boundary may round the other way)
and mean abs 1e-4 (measured 1.8e-6)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from m3p_tpu.ops import fused_ffn as jffn
from m3p_tpu_torch.ops import fused_ffn as tffn
from m3p_tpu_torch.ops.fused_ffn import fused_ffn_ln, reference_ffn_ln

torch.set_num_threads(1)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def ffn_inputs(m, d, h, seed=0):
    """x, W1 (D, H), b1, W2 (H, D), b2, gamma, beta as fp32 numpy arrays:
    nonzero biases, gamma away from 1."""
    rng = np.random.RandomState(seed)
    x = rng.randn(m, d)
    w1 = rng.randn(d, h) * 0.1
    b1 = rng.randn(h) * 0.1
    w2 = rng.randn(h, d) * 0.1
    b2 = rng.randn(d) * 0.1
    gamma = 1.0 + 0.1 * rng.randn(d)
    beta = 0.1 * rng.randn(d)
    return [a.astype(np.float32) for a in (x, w1, b1, w2, b2, gamma, beta)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m", [1, 70])
@pytest.mark.parametrize("d,h", [(64, 256), (128, 512)])
def test_plain_version_matches_the_pallas_kernel(dtype, m, d, h):
    tdt, jdt = DTYPES[dtype]
    arrays = ffn_inputs(m, d, h)
    with pltpu.force_tpu_interpret_mode():
        want = jffn.fused_ffn_ln(*(jnp.asarray(a, jdt) for a in arrays),
                                 tm=32)
        want = np.array(want.astype(jnp.float32))
    got = reference_ffn_ln(*(torch.from_numpy(a).to(tdt) for a in arrays))
    assert got.dtype == tdt and tuple(got.shape) == (m, d)
    err = np.abs(got.float().numpy() - want)
    if dtype == "float32":
        assert err.max() <= 1e-5, err.max()
    else:
        assert err.max() <= 1.6e-2 and err.mean() <= 1e-4, (err.max(),
                                                             err.mean())
    # the check has teeth: without the FFN the rows differ
    x = torch.from_numpy(arrays[0])
    ln = torch.nn.functional.layer_norm(x, (d,), eps=1e-12)
    assert np.abs(ln.numpy() - want).max() > 0.1


def test_the_dispatcher_takes_the_plain_version_on_the_cpu():
    arrays = [torch.from_numpy(a) for a in ffn_inputs(9, 24, 40)]
    got = fused_ffn_ln(*arrays)
    assert torch.equal(got, reference_ffn_ln(*arrays))
    assert fused_ffn_ln.launches == 0
    empty = fused_ffn_ln(arrays[0][:0], *arrays[1:])
    assert tuple(empty.shape) == (0, 24)


def test_the_dispatcher_refuses_what_the_kernel_does_not_take():
    arrays = [torch.from_numpy(a) for a in ffn_inputs(9, 24, 40)]
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_ffn_ln(*(a.to("meta") for a in arrays))
    with pytest.raises(TypeError, match="one dtype"):
        fused_ffn_ln(arrays[0].to(torch.bfloat16), *arrays[1:])
    with pytest.raises(TypeError, match="one dtype"):
        fused_ffn_ln(*(a.double() for a in arrays))
    x, w1, b1, w2, b2, g, be = arrays
    with pytest.raises(ValueError, match="contiguous"):
        fused_ffn_ln(x, w1.t().contiguous().t(), b1, w2, b2, g, be)
    with pytest.raises(ValueError, match="do not fit"):
        fused_ffn_ln(x, w1, b1, w2.t().contiguous(), b2, g, be)
    big = [torch.from_numpy(a) for a in ffn_inputs(2, 1025, 8)]
    with pytest.raises(ValueError, match="D=1025"):
        fused_ffn_ln(*big)
    assert tffn.MAX_D == 1024
