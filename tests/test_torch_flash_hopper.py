"""K1's Hopper path, on the CPU: which forward kernel the wrapper picks
(``flash_fwd_path``), the TMA geometry it hands that kernel
(``flash_tma_geometry``: dims innermost first, then byte strides), and what
the wrapper refuses before it builds or launches anything.

The kernel itself (``csrc/flash_fwd_hopper.cu``) runs only on the card:
``tests/test_torch_kernels_cuda.py`` holds it against the plain version
there.  Here no test needs a GPU or ``nvcc``.
"""

import pytest
import torch

from megatron_llm_tpu_torch.ops import kernels as pt_kernels

BF16, FP32, FP16 = torch.bfloat16, torch.float32, torch.float16


@pytest.mark.parametrize("head_dim", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [FP32, BF16, FP16])
def test_path_rule(dtype, head_dim):
    hopper = {(BF16, 64), (BF16, 128)}   # the training shapes
    want = "hopper" if (dtype, head_dim) in hopper else "smem"
    assert pt_kernels.flash_fwd_path(dtype, head_dim) == want
    assert want in pt_kernels.FLASH_FWD_PATHS


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
