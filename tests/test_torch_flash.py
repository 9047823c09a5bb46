"""The port's dense-attention oracle and plain flash version against the JAX
package.

The same numpy inputs go through ``repro_torch.kernels.ref``, the JAX
oracle ``repro.kernels.ref.flash_attention_ref``, the Pallas kernel in
interpret mode and the reference's ``layers.blockwise_attention`` (what the
JAX ``attn_full`` computes). Tolerances are ``tests/test_kernels.py``'s:
2e-5 at float32 (the same operations, or a tiled online softmax against a
one-shot one), 2e-2 at bfloat16 (one rounding of the output). The CUDA
kernel is held against the plain version on the card
(``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pl_flash
from repro.models.layers import blockwise_attention as jax_blockwise
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch intra-op thread: test processes that each spin a pool of
    threads on a shared host slow one another down a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)

# tests/test_kernels.py's flash sweep; the Pallas kernel takes causal
# attention on square shapes only, the oracles take it cross-length too
SWEEP = [
    (1, 128, 128, 4, 4, 64),     # MHA
    (2, 256, 256, 8, 2, 64),     # GQA 4x
    (1, 128, 256, 8, 1, 128),    # MQA, cross-length
    (2, 64, 64, 2, 2, 32),
]


def _case(seed, B, Sq, Sk, H, Hkv, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd), np.float32),
            rng.standard_normal((B, Sk, Hkv, hd), np.float32),
            rng.standard_normal((B, Sk, Hkv, hd), np.float32))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,hd", SWEEP)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_oracle_matches_jax_and_pallas(B, Sq, Sk, H, Hkv, hd, causal,
                                             dtype):
    arrs = _case(0, B, Sq, Sk, H, Hkv, hd)
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    tol = F32 if dtype == "float32" else BF16
    got = ref.flash_attention_ref(*tx, causal=causal)
    assert got.dtype == tx[0].dtype and got.shape == (B, Sq, H, hd)
    np.testing.assert_allclose(
        _f32(got), _f32(jref.flash_attention_ref(*jx, causal=causal)), **tol)
    if not causal or Sq == Sk:
        np.testing.assert_allclose(
            _f32(got), _f32(pl_flash(*jx, causal=causal, bq=64, bk=64,
                                     interpret=True)), **tol)


@pytest.mark.parametrize("B,S,H,Hkv,hd", [
    (1, 128, 4, 4, 64),
    (2, 96, 8, 2, 64),
    (1, 37, 8, 1, 32),           # prime length, MQA
    (1, 600, 4, 2, 32),          # two q chunks of 300
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_is_the_reference_prefill_attention(B, S, H, Hkv, hd,
                                                        causal):
    """The plain version is the reference's ``blockwise_attention`` with the
    GQA head repeat folded in — what ``attn_full`` computes — and agrees
    with the oracle."""
    q, k, v = _case(1, B, S, S, H, Hkv, hd)
    got = ref.blockwise_attention(*map(torch.from_numpy, (q, k, v)),
                                  causal=causal)
    kr, vr = (np.repeat(a, H // Hkv, axis=2) for a in (k, v))
    want = jax_blockwise(jnp.asarray(q), jnp.asarray(kr), jnp.asarray(vr),
                         causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.flash_attention_ref(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)),
        **F32)


def test_plain_flash_keeps_the_io_dtype_of_the_reference():
    """At bfloat16 the score dot runs in the I/O dtype and the
    probabilities are cast back before the value product, as in the
    reference prefill."""
    q, k, v = _case(2, 1, 64, 64, 4, 2, 32)
    jx = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    tx = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = ref.blockwise_attention(*tx, causal=True)
    want = jax_blockwise(jx[0], jnp.repeat(jx[1], 2, axis=2),
                         jnp.repeat(jx[2], 2, axis=2), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), **BF16)


def test_ops_dispatch_flash_on_cpu_tensors_to_the_plain_version():
    q, k, v = map(torch.from_numpy, _case(3, 1, 40, 40, 4, 2, 32))
    ops.reset_counts()
    got = ops.flash_attention(q, k, v, causal=True)
    assert torch.equal(got, ref.blockwise_attention(q, k, v, causal=True))
    assert ops.plain_calls["flash_attention"] == 1 and fa.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, k, v)
