"""The weights bridge: the JAX package's params into the port's.

The port keeps the JAX parameter tree's layout (stacked ``[L, ...]``
layer leaves, ``[in, out]`` kernels, group-major fused QKV, GLU ``fc1`` as
``[h, 2, ffn]``), so the bridge is a leaf-for-leaf copy: give it the JAX
tree as nested dicts of numpy arrays (``jax.device_get(params)``) and it
returns the same tree of tensors on ``device``, floating leaves cast to
``dtype`` at load: the compute dtype for serving, ``torch.float32`` for
training's master weights.  :func:`opt_state_from_jax_numpy` carries the
JAX package's Adam state over the same way, and :func:`kv_pool_from_jax_numpy`
a quantized KV pool byte for byte.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def params_from_jax_numpy(tree: Any, device, dtype: torch.dtype) -> Any:
    """Nested dicts of numpy arrays -> the same nesting of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_jax_numpy(v, device, dtype)
                for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.kind == "f" or arr.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 has no torch counterpart in from_numpy
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=dtype)
    return torch.from_numpy(arr).to(device=device)


def opt_state_from_jax_numpy(state: Any, device) -> Dict[str, Any]:
    """optax ``ScaleByAdamState`` ``(count, mu, nu)`` as numpy
    (``jax.device_get(opt_state)``) -> the port's AdamW state
    ``{"count": int, "mu": tree, "nu": tree}`` with fp32 moments."""
    count, mu, nu = state.count, state.mu, state.nu
    return {"count": int(np.asarray(count)),
            "mu": params_from_jax_numpy(mu, device, torch.float32),
            "nu": params_from_jax_numpy(nu, device, torch.float32)}


def kv_pool_from_jax_numpy(q: Any, scale: Any, device):
    """A JAX ``kv_quant.QuantPagedKV`` as numpy (``q`` int8 or ml_dtypes'
    float8_e4m3fn, ``scale`` float32) -> the port's
    ``ops.kv_quant.QuantPagedKV`` on ``device``, byte for byte: int8 as it
    is, e4m3 through its raw bytes (numpy has no fp8 type torch reads)."""
    from megatron_llm_tpu_torch.ops.kv_quant import QuantPagedKV

    arr = np.asarray(q)
    if arr.dtype == np.int8:
        values = torch.from_numpy(arr.copy())
    elif arr.dtype.name == "float8_e4m3fn":
        values = torch.from_numpy(arr.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    else:
        raise ValueError(f"quantized KV values must be int8 or "
                         f"float8_e4m3fn, got {arr.dtype}")
    sc = np.asarray(scale)
    if sc.dtype != np.float32:
        raise ValueError(f"KV scales must be float32, got {sc.dtype}")
    return QuantPagedKV(values.to(device),
                        torch.from_numpy(sc.copy()).to(device))
