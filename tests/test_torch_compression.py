"""Port parity: gradient compression with error feedback.

``compress_grad`` and ``compress_tree`` at 8 and 4 bits run three steps
of error feedback on the same gradients in both packages: every payload
(int8 codes, or SAMD-packed int4 words: int32 in the port, uint32 in the
reference, the same bits), scale, dequantized gradient and residual
must be bit-identical (the same f32 operations in the same order).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.distributed import compression as J  # noqa: E402
from repro_torch.distributed import compression as T  # noqa: E402
from repro_torch.tree import named_leaves  # noqa: E402


def _bits(x):
    """Comparable bits of a port tensor or a reference array."""
    a = (x.detach().cpu().view(torch.int16).numpy()
         if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16
         else np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor)
                         else x))
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    if a.dtype == np.uint32:
        return a.view(np.int32)
    return a


def _same(got, want, what):
    g, w = _bits(got), _bits(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (what, g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w, err_msg=what)


def _grads(rng, step):
    """A mixed gradient tree: f32 and bf16 leaves of odd sizes (the int4
    payload's last word is partly padding), a zero leaf, and a leaf whose
    magnitude grows with the step."""
    return {"w": rng.standard_normal((13, 7)).astype(np.float32),
            "b": (rng.standard_normal((5,)) * 1e-3).astype(jnp.bfloat16),
            "zero": np.zeros((3, 3), np.float32),
            "blocks": [{"g": (rng.standard_normal((9,)) * 10.0 ** step)
                        .astype(np.float32)}]}


def _t(x):
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("bits", [8, 4])
def test_compress_grad_is_the_reference_bit_for_bit(bits):
    rng = np.random.default_rng(bits)
    shape = (37, 11)
    j_res = jnp.zeros(shape, jnp.float32)
    t_res = torch.zeros(shape, dtype=torch.float32)
    for step in range(3):
        g = (rng.standard_normal(shape) * (step + 1)).astype(np.float32)
        jq, js, j_res = J.compress_grad(jnp.asarray(g), j_res, bits)
        tq, ts, t_res = T.compress_grad(torch.from_numpy(g), t_res, bits)
        _same(tq, jq, f"payload, step {step}")
        _same(ts, js, f"scale, step {step}")
        _same(t_res, j_res, f"residual, step {step}")
        if bits == 4:
            assert tq.dtype == torch.int32 and tq.shape == (51,)
            deq_t = T.dequantize_int4_packed(tq, ts, g.size, shape)
            deq_j = J.dequantize_int4_packed(jq, js, g.size, shape)
        else:
            assert tq.dtype == torch.int8
            deq_t, deq_j = T.dequantize_int8(tq, ts), J.dequantize_int8(jq,
                                                                        js)
        _same(deq_t, deq_j, f"dequantized, step {step}")
    with pytest.raises(ValueError):
        T.compress_grad(torch.zeros(4), torch.zeros(4), 3)


@pytest.mark.parametrize("bits", [8, 4])
def test_compress_tree_is_the_reference_bit_for_bit(bits):
    rng = np.random.default_rng(10 + bits)
    first = _grads(rng, 0)
    j_res = J.init_residuals(jax.tree.map(jnp.asarray, first))
    t_res = T.init_residuals(jax.tree.map(_t, first))
    for step in range(3):
        g = first if step == 0 else _grads(rng, step)
        jg, j_res = J.compress_tree(jax.tree.map(jnp.asarray, g), j_res,
                                    bits)
        tg, t_res = T.compress_tree(jax.tree.map(_t, g), t_res, bits)
        for (name, got), (_, want) in zip(named_leaves(tg),
                                          named_leaves(jg)):
            _same(got, want, f"gradient {name}, step {step}")
        for (name, got), (_, want) in zip(named_leaves(t_res),
                                          named_leaves(j_res)):
            assert got.dtype == torch.float32
            _same(got, want, f"residual {name}, step {step}")
