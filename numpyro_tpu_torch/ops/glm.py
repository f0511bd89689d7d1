"""Fused Bernoulli-logits GLM log-likelihood + gradient (port of
``numpyro_tpu/ops/glm.py``).

``bernoulli_logits_loglik(w, data)`` is a differentiable scalar function of
``w`` for use inside a model via ``numpyro_tpu_torch.factor``.  It is a
``torch.autograd.Function`` whose forward returns the log-likelihood and its
gradient together (the gradient is saved for backward, like the JAX
``custom_vjp``), and whose ``vmap`` rule sends all chains of a
``torch.func.vmap`` to ONE evaluation (the JAX ``custom_vmap`` rule).

Where it runs is decided by the tensor's device, never guessed:

- CUDA: the hand-written kernels of ``numpyro_tpu_torch/csrc/glm.cu``
  (``glm_split`` for ``dtype="split"``, ``glm_fused`` for float32 and
  bfloat16 storage).  A build or launch failure raises.
- CPU: the plain PyTorch version of the same function
  (:func:`plain_value_and_grad`), which the CPU tests hold against JAX.
- Any other device raises.

Precision modes (``prepare_glm_data(..., dtype=...)``), as in the JAX
package: ``torch.float32`` (exact-f32 model; no TF32 anywhere), ``"split"``
(bf16-stored design matrix with f32-accurate hi+lo ``w``) and
``torch.bfloat16`` (all-bf16, including ``w`` and the residual).
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "BernoulliLogitsGLMData",
    "bernoulli_logits_loglik",
    "from_numpy_glm_data",
    "glm_value_and_grad",
    "launch_counts",
    "plain_value_and_grad",
    "prepare_glm_data",
    "reset_launch_counts",
    "split_hi_lo",
]

# same layout as the JAX package, so both score the same padded matrix; the
# CUDA kernel needs N_pad to be a multiple of its 4096-column chunk
_N_PAD = 32768
_LOG2 = math.log(2.0)

# launches of each kernel entry point (and calls of the plain version); a
# wrapper adds one where it launches, and nowhere else
launch_counts = {"glm_split": 0, "glm_fused_f32": 0, "glm_fused_bf16": 0, "plain": 0}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def _mode(dtype):
    if dtype == "split":
        return "split"
    if dtype in (torch.float32, "float32"):
        return "f32"
    if dtype in (torch.bfloat16, "bfloat16"):
        return "bf16"
    raise ValueError(f"unsupported GLM dtype {dtype!r}")


class BernoulliLogitsGLMData:
    """Pre-laid-out design matrix: Xᵀ padded to ``(D_pad, N_pad)`` with the
    observation row padded to match.  Build once via :func:`prepare_glm_data`
    (or :func:`from_numpy_glm_data`); reused across every leapfrog step."""

    def __init__(self, x_t, y_row, n, d, dtype):
        if x_t.device != y_row.device:
            raise ValueError("x_t and y_row must be on the same device")
        self.x_t = x_t  # (D_pad, N_pad) float32 or bfloat16
        self.y_row = y_row  # (1, N_pad) float32
        self.n = n
        self.d = d
        self.dtype = dtype
        self.mode = _mode(dtype)

    @property
    def device(self):
        return self.x_t.device


def prepare_glm_data(X, y, dtype=torch.float32):
    """Lay out an (N, D) design matrix and (N,) binary observations on the
    device of ``X`` (see the module docstring for ``dtype``)."""
    N, D = X.shape
    mode = _mode(dtype)
    d_pad = max(8 * ((D + 7) // 8), 8)
    n_pad = _N_PAD * ((N + _N_PAD - 1) // _N_PAD)
    store = torch.float32 if mode == "f32" else torch.bfloat16
    x_t = torch.zeros((d_pad, n_pad), dtype=store, device=X.device)
    x_t[:D, :N] = X.T.to(store)
    y_row = torch.zeros((1, n_pad), dtype=torch.float32, device=X.device)
    y_row[0, :N] = y.to(torch.float32)
    return BernoulliLogitsGLMData(x_t, y_row, N, D, dtype)


def from_numpy_glm_data(x_t, y_row, n, d, dtype, device="cpu"):
    """The port's data object from the numpy arrays of a JAX
    ``BernoulliLogitsGLMData`` (bf16 ``x_t`` arrives as numpy's 2-byte
    ``bfloat16`` extension type and is reinterpreted bit for bit)."""
    import numpy as np

    if x_t.dtype.name == "bfloat16":
        x = torch.from_numpy(x_t.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        x = torch.from_numpy(np.array(x_t, dtype=np.float32))
    y = torch.from_numpy(np.array(y_row, dtype=np.float32))
    return BernoulliLogitsGLMData(x.to(device), y.to(device), int(n), int(d), dtype)


def split_hi_lo(w):
    """Split f32 ``w`` into bf16 ``(hi, lo)`` with ``hi + lo == w`` to
    ~2^-17 relative.  ``hi`` is round-to-nearest-even on the int32 bits (the
    kernel's arithmetic, and ``lax.reduce_precision``'s); an f32->bf16->f32
    round trip would do too in eager torch, but the bit form is the one the
    kernels use and cannot be simplified away by a compiler."""
    bits = w.contiguous().view(torch.int32)
    rne = (bits + 0x7FFF + ((bits >> 16) & 1)) & -65536  # 0xFFFF0000
    hi = rne.view(torch.float32)
    return hi.to(torch.bfloat16), (w - hi).to(torch.bfloat16)


def _round_bf16(v):
    return v.to(torch.bfloat16).to(torch.float32)


def plain_value_and_grad(w, data):
    """Plain PyTorch version of the kernels: ``(B, d)`` f32 ``w`` ->
    ``(loglik (B,), grad (B, d))`` with the kernels' hi/lo arithmetic."""
    launch_counts["plain"] += 1
    b, d = w.shape
    d_pad, n_pad = data.x_t.shape
    x = data.x_t.to(torch.float32)
    w_pad = torch.zeros((b, d_pad), dtype=torch.float32, device=w.device)
    w_pad[:, :d] = w
    if data.mode == "split":
        hi, lo = split_hi_lo(w_pad)
        logits = hi.to(torch.float32) @ x + lo.to(torch.float32) @ x
    elif data.mode == "bf16":
        logits = _round_bf16(w_pad) @ x
    else:
        logits = w_pad @ x
    y = data.y_row
    e = torch.exp(-logits.abs())
    nll = logits.clamp(min=0) + torch.log1p(e) - y * logits
    # f64 sum in a fixed order: the potential reaches ~2e5 at covtype scale
    nll = nll.sum(-1, dtype=torch.float64) - (n_pad - data.n) * _LOG2
    r = torch.where(logits >= 0, 1.0, e) / (1.0 + e) - y
    if data.mode == "split":
        r_hi, r_lo = split_hi_lo(r)
        grad = r_hi.to(torch.float32) @ x.T + r_lo.to(torch.float32) @ x.T
    elif data.mode == "bf16":
        grad = _round_bf16(r) @ x.T
    else:
        grad = r @ x.T
    return (-nll).to(torch.float32), -grad[:, :d]


def _kernel_value_and_grad(w, data):
    """Launch the CUDA kernel for ``data.mode`` on ``w``'s current stream."""
    from numpyro_tpu_torch.ops import _cuda

    x_t, y_row = data.x_t, data.y_row
    if w.dtype != torch.float32 or w.dim() != 2 or not w.is_contiguous():
        raise ValueError("w must be a contiguous (B, D) float32 tensor")
    if x_t.device != w.device:
        raise ValueError(f"w is on {w.device} but the GLM data on {x_t.device}")
    if not (x_t.is_contiguous() and y_row.is_contiguous()):
        raise ValueError("GLM data tensors must be contiguous")
    b, d = w.shape
    d_pad, n_pad = x_t.shape
    if d != data.d or d_pad > 256:
        raise ValueError(f"w has {d} columns; the data has {data.d} (D_pad {d_pad} <= 256)")
    lib = _cuda.load()
    chunk = lib.glm_chunk_columns()
    if n_pad % chunk:
        raise ValueError(f"N_pad={n_pad} is not a multiple of {chunk}")
    dev = w.device
    pe_part = torch.empty((n_pad // chunk, b), dtype=torch.float32, device=dev)
    g_part = torch.empty((n_pad // chunk, b, d_pad), dtype=torch.float32, device=dev)
    ll = torch.empty((b,), dtype=torch.float32, device=dev)
    grad = torch.empty((b, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        common = (y_row.data_ptr(), n_pad, data.n, pe_part.data_ptr(),
                  g_part.data_ptr(), ll.data_ptr(), grad.data_ptr(), stream)
        if data.mode == "split":
            name = "glm_split"
            err = lib.glm_split_launch(
                w.data_ptr(), b, d, d_pad, x_t.data_ptr(), *common
            )
        else:
            name = "glm_fused_" + data.mode
            want = torch.float32 if data.mode == "f32" else torch.bfloat16
            if x_t.dtype != want:
                raise ValueError(f"{data.mode} mode needs {want} x_t, got {x_t.dtype}")
            err = lib.glm_fused_launch(
                w.data_ptr(), b, d, d_pad, x_t.data_ptr(),
                int(data.mode == "bf16"), *common,
            )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")
    launch_counts[name] += 1
    return ll, grad


def glm_value_and_grad(w, data):
    """(B, D) chains -> (loglik (B,), grad (B, D)): the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    if w.device.type == "cuda":
        return _kernel_value_and_grad(w, data)
    if w.device.type == "cpu":
        if data.device.type != "cpu":
            raise ValueError(f"w is on the CPU but the GLM data on {data.device}")
        return plain_value_and_grad(w, data)
    raise NotImplementedError(f"no GLM kernel for device {w.device}")


class _GLMLoglik(torch.autograd.Function):
    """(loglik, grad) with grad saved for backward; ``vmap`` batches chains
    into one evaluation."""

    @staticmethod
    def forward(w, data):
        flat = w.reshape(-1, w.shape[-1]).contiguous()
        ll, g = glm_value_and_grad(flat, data)
        return ll.reshape(w.shape[:-1]), g.reshape(w.shape)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_backward(output[1])

    @staticmethod
    def backward(ctx, ct, _ct_grad):
        (g,) = ctx.saved_tensors
        return ct[..., None] * g, None

    @staticmethod
    def vmap(info, in_dims, w, data):
        if in_dims[0] is None:
            w = w.expand(info.batch_size, *w.shape)
        else:
            w = w.movedim(in_dims[0], 0)
        return _GLMLoglik.apply(w, data), (0, 0)


def bernoulli_logits_loglik(w, data):
    """Σ_n log Bernoulli(y_n | logits = x_n · w), fused with its gradient.

    Differentiable in ``w`` only; ``data`` must come from
    :func:`prepare_glm_data`.  Use inside a model as
    ``numpyro_tpu_torch.factor("lik", bernoulli_logits_loglik(w, data))``.
    """
    return _GLMLoglik.apply(w, data)[0]
