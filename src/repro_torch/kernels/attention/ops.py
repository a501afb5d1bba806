"""Public attention entry point: the CUDA kernels on the card, the plain
version on the CPU.

Counterpart of ``repro/kernels/attention/ops.py::flash_attention``.  The
choice follows the tensors' device only: a CUDA tensor always launches the
hand-written kernel (or raises), a CPU tensor takes the plain version,
which autograd differentiates.  Neither copies its operands: both take q,
k and v at their strides.

On the card, a call that autograd records (grad mode on and an operand
that requires grad) goes through ``FlashAttentionFn``: the forward kernel
with its per-row log-sum-exp, and the hand-written backward kernel for the
gradients, in the operands' dtype: float32 from the Tao trainer, bfloat16
from the LLM trainer (``train/trainer.py::make_train_step``).  The
backward takes no segment ids, q_offset 0, Sq == Sk and D == Dv <= 128; a
call outside that raises rather than run something else (nothing falls
back to the plain version or to a library).  Under ``no_grad`` or
``inference_mode``, as in the engine and the serving entry points, the
call is the forward launch alone.
"""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import flash_attention_bwd_cuda, flash_attention_cuda
from .ref import attention_plain

__all__ = ["FlashAttentionFn", "flash_attention"]


class FlashAttentionFn(torch.autograd.Function):
    """Attention over CUDA tensors with the hand-written backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids: Optional[torch.Tensor] = None,
    *,
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    """Attention over (B, H, S, D) operands; ``segment_ids`` ((B, Sk) int32,
    optional) confines attention to equal-id spans."""
    if not q.is_cuda:
        return attention_plain(q, k, v, segment_ids, causal=causal, q_offset=q_offset)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if segment_ids is not None or q_offset != 0 or q.shape != k.shape or k.shape != v.shape:
            raise ValueError(
                "the attention backward takes no segment ids, q_offset 0 and q, k, v "
                f"of one shape; got segment_ids={segment_ids is not None}, "
                f"q_offset={q_offset}, q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}"
            )
        return FlashAttentionFn.apply(q, k, v, causal)
    return flash_attention_cuda(q, k, v, segment_ids, causal=causal, q_offset=q_offset)
