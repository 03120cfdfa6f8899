"""The Hopper path of K1-K3, on the CPU: which kernels the wrappers pick
(``flash_path``, one rule for the forward and both backward kernels), the
TMA geometry they hand those kernels (``flash_tma_geometry``: dims
innermost first, then byte strides), ``do`` as autograd hands it to the
backward, and what the wrappers refuse before they build or launch
anything.

The kernels themselves (``csrc/flash_fwd_hopper.cu``,
``csrc/flash_bwd_hopper.cu``) run only on the card:
``tests/test_torch_kernels_cuda.py`` holds them against the plain versions
there.  Here no test needs a GPU or ``nvcc``.
"""

import pytest
import torch

from megatron_llm_tpu_torch.ops import flash_attention as pt_flash
from megatron_llm_tpu_torch.ops import kernels as pt_kernels

BF16, FP32, FP16 = torch.bfloat16, torch.float32, torch.float16


@pytest.mark.parametrize("head_dim", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [FP32, BF16, FP16])
def test_path_rule(dtype, head_dim):
    hopper = {(BF16, 64), (BF16, 128)}   # the training shapes
    want = "hopper" if (dtype, head_dim) in hopper else "smem"
    assert pt_kernels.flash_path(dtype, head_dim) == want
    assert want in pt_kernels.FLASH_PATHS


def _geo(t):
    return pt_kernels.flash_tma_geometry(t)


def test_geometry_contiguous():
    q = torch.zeros(2, 300, 8, 128, dtype=BF16)
    # dims (d, heads, s, b); byte strides of heads, s, b
    assert _geo(q) == [128, 8, 300, 2, 256, 8 * 256, 300 * 8 * 256]
    q32 = torch.zeros(3, 5, 4, 64, dtype=FP32)
    assert _geo(q32) == [64, 4, 5, 3, 256, 4 * 256, 5 * 4 * 256]


def test_geometry_fused_qkv_views():
    """q / k / v sliced from one ``[b, s, n + 2 nkv, d]`` buffer, as the
    model's qkv projection leaves them: each view strides over the whole
    fused row."""
    b, s, n, nkv, d = 2, 300, 8, 2, 128
    qkv = torch.zeros(b, s, n + 2 * nkv, d, dtype=BF16)
    q, k, v = qkv[:, :, :n], qkv[:, :, n:n + nkv], qkv[:, :, n + nkv:]
    row = (n + 2 * nkv) * d * 2          # bytes of one fused position
    assert _geo(q) == [d, n, s, b, d * 2, row, s * row]
    assert _geo(k) == [d, nkv, s, b, d * 2, row, s * row]
    assert _geo(v) == [d, nkv, s, b, d * 2, row, s * row]
    # the views start where their heads start; TMA takes the view's base
    assert k.data_ptr() - q.data_ptr() == n * d * 2
    assert v.data_ptr() - q.data_ptr() == (n + nkv) * d * 2
    for t in (q, k, v):
        assert pt_kernels.flash_rows_aligned(t)


def test_geometry_transposed_then_contiguous_and_transposed_view():
    heads_first = torch.zeros(2, 8, 300, 64, dtype=BF16)   # [b, n, s, d]
    packed = heads_first.transpose(1, 2).contiguous()      # [b, s, n, d]
    assert _geo(packed) == [64, 8, 300, 2, 128, 8 * 128, 300 * 8 * 128]
    view = heads_first.transpose(1, 2)                      # no copy
    assert _geo(view) == [64, 8, 300, 2, 300 * 128, 128, 8 * 300 * 128]
    assert pt_kernels.flash_rows_aligned(view)


def test_geometry_size_one_dims_get_packed_strides():
    """A dim of size 1 never moves the address; it gets the stride a packed
    layout would give it, whatever torch reports there."""
    t = torch.zeros(1, 5, 1, 64, dtype=BF16)
    assert _geo(t) == [64, 1, 5, 1, 128, 128, 5 * 128]
    odd = torch.zeros(5, 1, 64, dtype=BF16).unsqueeze(0)   # torch's own
    odd = odd.as_strided((1, 5, 1, 64), (0, 64, 7, 1))     # strides there
    assert _geo(odd) == [64, 1, 5, 1, 128, 128, 5 * 128]


@pytest.fixture
def no_build(monkeypatch):
    """Fail the test if the wrapper gets as far as building the kernels."""
    def refuse(*a, **kw):
        raise AssertionError("the wrapper reached the kernel build")
    monkeypatch.setattr(pt_kernels.build, "library", refuse)


def _qkv(dtype=BF16, d=64, s=16):
    return (torch.zeros(1, s, 4, d, dtype=dtype),
            torch.zeros(1, s, 2, d, dtype=dtype),
            torch.zeros(1, s, 2, d, dtype=dtype))


def test_wrapper_refuses_misaligned_strides(no_build):
    q, k, v = _qkv()
    wide = torch.zeros(1, 16, 4, 65, dtype=BF16)[..., :64]   # 130-byte rows
    assert not pt_kernels.flash_rows_aligned(wide)
    with pytest.raises(ValueError, match="16-byte"):
        pt_kernels.flash_fwd_kernel(wide, k, v, scale=0.125)
    with pytest.raises(ValueError, match="16-byte"):
        pt_kernels.flash_fwd_kernel(q, torch.zeros(1, 16, 2, 65, dtype=BF16)
                                    [..., :64], v, scale=0.125)
    with pytest.raises(ValueError, match="last dimension"):
        pt_kernels.flash_fwd_kernel(
            q, k.transpose(2, 3).contiguous().transpose(2, 3), v,
            scale=0.125)


def test_wrapper_refuses_fp16(no_build):
    q, k, v = _qkv(FP16)
    with pytest.raises(ValueError, match="dtype"):
        pt_kernels.flash_fwd_kernel(q, k, v, scale=0.125)


@pytest.mark.parametrize("dtype,d", [(BF16, 64), (BF16, 128), (FP32, 128)])
def test_wrapper_refuses_cpu_tensors(no_build, dtype, d):
    """Aligned inputs the kernels take, but on the CPU: the wrapper raises;
    only the dispatch (``ops.flash_attention``) sends CPU tensors to the
    plain version."""
    q, k, v = _qkv(dtype, d)
    pt_kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        pt_kernels.flash_fwd_kernel(q, k, v, scale=0.125)
    assert pt_kernels.launch_counts()["flash_fwd_kernel"] == 0


def _do_as_autograd_hands_it(monkeypatch, loss_fn, b=2, s=32, n=4, d=64):
    """Run ``flash_attention`` forward and backward on CPU tensors and
    return ``do`` as the backward receives it, after the dispatch's
    row-alignment step (what the kernels would get on the card)."""
    seen = {}
    real_bwd = pt_flash.flash_bwd

    def spy(q, k, v, out, lse, do, *a, **kw):
        seen["do"] = pt_flash._rows_aligned(do)
        return real_bwd(q, k, v, out, lse, do, *a, **kw)

    monkeypatch.setattr(pt_flash, "flash_bwd", spy)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(b, s, h, d, generator=g).requires_grad_(True)
               for h in (n, n // 2, n // 2))
    loss_fn(pt_flash.flash_attention(q, k, v), g).backward()
    return seen["do"]


def test_do_geometry_contiguous(monkeypatch):
    """The model's path: the attention output reshaped to ``[b, s, n d]``
    into the dense projection; ``do`` arrives packed ``[b, s, n, d]``."""
    b, s, n, d = 2, 32, 4, 64

    def loss(out, g):
        w = torch.randn(n * d, 8, generator=g)
        return (out.reshape(b, s, n * d) @ w).square().sum()

    do = _do_as_autograd_hands_it(monkeypatch, loss)
    assert do.is_contiguous() and pt_kernels.flash_rows_aligned(do)
    esz = do.element_size()
    assert _geo(do) == [d, n, s, b, d * esz, n * d * esz, s * n * d * esz]


def test_do_geometry_transposed_then_contiguous(monkeypatch):
    """A caller that moves heads first and packs (``transpose(1, 2)
    .contiguous()``): ``do`` arrives as the transposed view of a packed
    ``[b, n, s, d]`` gradient, which TMA reads in place."""
    b, s, n, d = 2, 32, 4, 64

    def loss(out, g):
        heads_first = out.transpose(1, 2).contiguous()
        return (heads_first * torch.randn(b, n, s, d, generator=g)).sum()

    do = _do_as_autograd_hands_it(monkeypatch, loss)
    assert not do.is_contiguous() and pt_kernels.flash_rows_aligned(do)
    esz = do.element_size()
    assert _geo(do) == [d, n, s, b, s * d * esz, d * esz, n * s * d * esz]


def test_do_of_a_sum_is_copied(monkeypatch):
    """``out.sum()`` hands a broadcast gradient (stride 0 everywhere, the
    last dimension too): the dispatch gives the kernels a packed copy."""
    do = _do_as_autograd_hands_it(monkeypatch, lambda out, g: out.sum())
    assert do.is_contiguous() and pt_kernels.flash_rows_aligned(do)
    assert bool((do == 1).all())


def _bwd_args(dtype=BF16, d=64, s=16):
    q, k, v = _qkv(dtype, d, s)
    rows = torch.zeros(1, 4, s, 1, dtype=torch.float32)
    return q, k, v, torch.zeros_like(q), rows, rows.clone()


BWD_WRAPPERS = ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")


@pytest.mark.parametrize("wrapper", BWD_WRAPPERS)
def test_bwd_wrappers_refuse_misaligned_strides(no_build, wrapper):
    fn = getattr(pt_kernels, wrapper)
    q, k, v, do, lse, delta = _bwd_args()
    wide = torch.zeros(1, 16, 4, 65, dtype=BF16)[..., :64]   # 130-byte rows
    with pytest.raises(ValueError, match="16-byte"):
        fn(q, k, v, wide, lse, delta, scale=0.125)
    with pytest.raises(ValueError, match="16-byte"):
        fn(wide, k, v, do, lse, delta, scale=0.125)
    with pytest.raises(ValueError, match="last dimension"):
        fn(q, k, v, do.transpose(2, 3).contiguous().transpose(2, 3), lse,
           delta, scale=0.125)


@pytest.mark.parametrize("wrapper", BWD_WRAPPERS)
def test_bwd_wrappers_refuse_fp16(no_build, wrapper):
    q, k, v, do, lse, delta = _bwd_args(FP16)
    with pytest.raises(ValueError, match="dtype"):
        getattr(pt_kernels, wrapper)(q, k, v, do, lse, delta, scale=0.125)


@pytest.mark.parametrize("dtype,d", [(BF16, 64), (BF16, 128), (FP32, 128)])
@pytest.mark.parametrize("wrapper", BWD_WRAPPERS)
def test_bwd_wrappers_refuse_cpu_tensors(no_build, wrapper, dtype, d):
    """Aligned inputs the kernels take, but on the CPU: the wrapper raises,
    counts no launch and records no path."""
    q, k, v, do, lse, delta = _bwd_args(dtype, d)
    fn = getattr(pt_kernels, wrapper)
    pt_kernels.reset_launch_counts()
    fn.last_path = None
    with pytest.raises(ValueError, match="CUDA"):
        fn(q, k, v, do, lse, delta, scale=0.125)
    assert pt_kernels.launch_counts()[wrapper] == 0
    assert fn.last_path is None
