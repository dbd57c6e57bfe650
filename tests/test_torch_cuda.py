"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version on the same inputs, over the block sizes the kernels take
(8 to 256, powers of two or not), one member and a stacked bucket, and the
plan path end to end against the float64 oracle.

Run on a machine with an NVIDIA GPU and nvcc:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Without a card every test here skips (the kernels have no CPU mode). This
file imports neither jax nor the JAX package, so it runs where only
PyTorch is installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (BSR, CSR, ELLBSR, SELLBSR, Schedule,
                              spmv_oracle)
from repro_torch.core.synthetic import gen_zipf
from repro_torch.kernels.bsr_spmv import kernel as K
from repro_torch.kernels.bsr_spmv import ops, ref
from repro_torch.sparse import (launch_count, plan, plan_bucket,
                                reset_counters)

pytestmark = pytest.mark.cuda
SIZES = [(64, 8), (100, 16), (257, 32), (96, 96), (512, 128), (600, 256)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    # the plain versions run on the card here: keep them in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _dense(n, density, seed):
    rng = np.random.default_rng(seed)
    d = (rng.random((n, n)) < density) * rng.standard_normal((n, n))
    return d.astype(np.float32)


def _x_blocks(x, n_bc, bs, device):
    xb = np.zeros((n_bc * bs,) + x.shape[1:], np.float32)
    xb[: x.shape[0]] = x
    return torch.as_tensor(xb.reshape((n_bc, bs) + x.shape[1:]),
                           device=device)


@pytest.mark.parametrize("n,bs", SIZES)
@pytest.mark.parametrize("layout", ["ell", "sell"])
@pytest.mark.parametrize("multi", [False, True])
def test_kernel_matches_plain(card, n, bs, layout, multi):
    bsr = BSR.from_csr(CSR.from_dense(_dense(n, 0.06, n)), bs)
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, 16) if multi else n).astype(np.float32)
    xb = _x_blocks(x, -(-n // bs), bs, card)
    if layout == "ell":
        idx, cols, blocks, _ = ops.ell_device_arrays(ELLBSR.from_bsr(bsr),
                                                     card)
        args = (idx, cols, blocks)
        fn = K.bsr_spmm_cuda if multi else K.bsr_spmv_cuda
        plain = ref.ref_bsr_spmm if multi else ref.ref_bsr_spmv
    else:
        args = ops.sell_device_arrays(SELLBSR.from_bsr(bsr, 4, 8), card)
        fn = K.bsr_spmm_sell_cuda if multi else K.bsr_spmv_sell_cuda
        plain = (ref.ref_bsr_spmm_sell_perm if multi
                 else ref.ref_bsr_spmv_sell_perm)
    y = fn(*args, xb)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, plain(*args, xb), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("layout", ["ell", "sell"])
def test_plan_and_bucket_on_card(card, layout):
    mats = [gen_zipf(n, seed=n) for n in (700, 600, 500)]
    s = (Schedule("bsr", 64, 1.0, layout="sell", slice_height=4)
         if layout == "sell" else Schedule("bsr", 64, 1.0))
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal(m.shape[1]).astype(np.float32) for m in mats]
    for m, x in zip(mats, xs):
        y = plan("spmv", (m,), schedule=s).execute(x).cpu().numpy()
        np.testing.assert_allclose(y, spmv_oracle(m, x), rtol=1e-4,
                                   atol=1e-4)
    name = "bsr_spmv_sell" if layout == "sell" else "bsr_spmv_ell"
    before = K.LAUNCHES[name]
    reset_counters()
    ys = plan_bucket("spmv", mats, s).execute(xs)
    assert launch_count("spmv") == 1 and K.LAUNCHES[name] == before + 1
    for y, m, x in zip(ys, mats, xs):
        np.testing.assert_allclose(y.cpu().numpy(), spmv_oracle(m, x),
                                   rtol=1e-4, atol=1e-4)
