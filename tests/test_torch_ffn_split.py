"""The FFN's plain version split as its wgmma body is: the up-projection
(``ffn_up_reference``) and the down-projection with the residual LayerNorm
(``ffn_down_ln_reference``), against ``ffn_saved_reference`` and the JAX
package's interpreted saved-residual kernel (CPU); and the C declarations of
the kernels against the ctypes signatures they are called with.
"""

import ctypes
import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from vibertgrid_tpu_torch.ops import fused_ffn as ffn
from vibertgrid_tpu_torch.ops import kernels


def _case(n, d, f, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w1 = (rng.standard_normal((d, f)) * d ** -0.5).astype(np.float32)   # JAX layout [in, out]
    w2 = (rng.standard_normal((f, d)) * f ** -0.5).astype(np.float32)
    b1 = (rng.standard_normal(f) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(d) * 0.1).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    bt = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return x, w1, b1, w2, b2, g, bt


def _torch_args(x, w1, b1, w2, b2, g, bt, dtype):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    # x in the compute dtype, the weights in nn.Linear's [out, in], fp32 vectors
    return t(x).to(dtype), t(w1.T), t(b1), t(w2.T), t(b2), t(g), t(bt)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_composition_is_the_saved_reference_bit_for_bit(dtype, rate):
    # a ragged row count: 37 is no multiple of any block's rows
    x, w1, b1, w2, b2, g, bt = _torch_args(*_case(37, 64, 256, seed=21), dtype)
    eps, seed = 1e-12, 29
    h, h1 = ffn.ffn_up_reference(x, w1, b1)
    y, yhat, rsig = ffn.ffn_down_ln_reference(h, x, w2, b2, g, bt, eps, seed, rate)
    want = ffn.ffn_saved_reference(x, w1, b1, w2, b2, g, bt, eps, seed, rate)
    assert h.dtype == h1.dtype == y.dtype == yhat.dtype == dtype and rsig.dtype == torch.float32
    assert h.shape == h1.shape == (37, 256) and rsig.shape == (37, 1)
    for name, a, w in zip(("y", "h1", "yhat", "rsig"), (y, h1, yhat, rsig), want):
        assert torch.equal(a, w), name
    # h is gelu of the unrounded h1, rounded once to the compute dtype
    h1_f32 = x.float() @ w1.to(dtype).float().t() + b1
    assert torch.equal(h, ffn.gelu_exact_f32(h1_f32).to(dtype))
    assert torch.equal(ffn.ffn_reference(x, w1, b1, w2, b2, g, bt, eps, seed, rate), y)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_split_matches_jax_interpreted_kernel(rate):
    from vibertgrid_tpu.ops.fused_ffn import _fused_ffn_saved_fwd

    case = _case(37, 64, 128, seed=22)
    seed, eps = 41, 1e-12
    y, (_, h1, yhat, rsig, *_rest) = _fused_ffn_saved_fwd(
        *(jnp.asarray(a) for a in case), jnp.int32(seed), eps, rate, True)
    x, w1, b1, w2, b2, g, bt = _torch_args(*case, torch.float32)
    h, got_h1 = ffn.ffn_up_reference(x, w1, b1)
    got = (*ffn.ffn_down_ln_reference(h, x, w2, b2, g, bt, eps, seed, rate), got_h1)
    # fp32 both sides; products of 64 and 128 terms summed in another order
    for name, a, w in zip(("y", "yhat", "rsig", "h1"), got, (y, yhat, rsig, h1)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5, err_msg=name)


# ------------------------------------------- C declarations vs ctypes signatures

_C_TYPES = {"int": ctypes.c_int, "unsigned": ctypes.c_uint, "float": ctypes.c_float}


def _extern_c_declarations():
    """``{name: [ctypes type of each parameter]}`` of every ``extern "C"``
    function in the port's CUDA sources, pointers as ``c_void_p``."""
    found = {}
    for src in sorted(kernels.CSRC.glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r'extern "C" [^(]*?\b(vg_\w+)\s*\(([^)]*)\)', text):
            params = [p.strip() for p in m.group(2).split(",") if p.strip()]
            types = []
            for p in params:
                decl = " ".join(p.split()[:-1]) + ("*" if "*" in p.split()[-1] else "")
                if "*" in decl:
                    types.append(ctypes.c_void_p)
                else:
                    types.append(_C_TYPES[decl.replace("const ", "")])
            found[m.group(1)] = types
    return found


def test_every_kernel_entry_point_has_a_signature():
    declared = set(_extern_c_declarations())
    # vg_error_string returns a string: library() types it by hand
    assert declared - {"vg_error_string"} == set(kernels._SIGNATURES)
    assert _extern_c_declarations()["vg_error_string"] == [ctypes.c_int]
    assert set(kernels.SOURCES) == {p.name for p in kernels.CSRC.glob("*.cu")}


@pytest.mark.parametrize("name", sorted(kernels._SIGNATURES))
def test_signature_matches_the_c_declaration(name):
    declared = _extern_c_declarations()[name]
    # the same number of arguments, and c_void_p wherever C takes a pointer:
    # a pointer passed as ctypes' default int is cut to 32 bits
    assert kernels._SIGNATURES[name] == declared


def test_the_parse_sees_pointers_and_scalars():
    decls = _extern_c_declarations()
    ffn_args = decls["vg_fused_ffn"]
    assert ffn_args[:12] == [ctypes.c_void_p] * 12   # x .. rsig and the h scratch
    assert ffn_args[12:16] == [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float]
    assert ffn_args[-1] == ctypes.c_void_p           # the stream
