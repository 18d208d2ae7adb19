"""Adam and the LR schedule (transformer_stm_tpu/train/optimizer.py).

Adam with Keras-default hyperparameters (beta1 0.9, beta2 0.999, eps 1e-7,
the reference's keras.optimizers.Adam(1e-3)), f32 bias correction, and the
AdamW branch: ``weight_decay`` > 0 adds decay * p to the update of every
kernel (a parameter of 2 or more dimensions), not the biases.  The schedule
multiplies lr by 0.8 every 50 epochs.

The JAX functions are pure; here ``adam_update`` updates the parameters and
the moments in place, with multi-tensor (``torch._foreach_*``) ops so that
a step launches a few kernels rather than a few per parameter.  The moments
are keyed by parameter name, the JAX path with dots, so a checkpoint's
``o/mu/<path>`` leaves map one to one.

    opt = adam_init(model)
    adam_update(grads, opt, params, lr)    # params: the model's, in order
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence

import numpy as np
import torch


@dataclass
class AdamState:
    step: int  # updates so far
    mu: Dict[str, torch.Tensor]  # first moments, by parameter name
    nu: Dict[str, torch.Tensor]  # second moments, by parameter name


def adam_init(model: torch.nn.Module) -> AdamState:
    return AdamState(
        step=0,
        mu={n: torch.zeros_like(p) for n, p in model.named_parameters()},
        nu={n: torch.zeros_like(p) for n, p in model.named_parameters()})


@torch.no_grad()
def adam_update(grads: Sequence[torch.Tensor], opt: AdamState,
                params: Sequence[torch.Tensor], lr: float, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-7,
                weight_decay: float = 0.0) -> None:
    """One Adam (AdamW with ``weight_decay`` > 0) step on ``params``, whose
    order is that of ``opt.mu``, in place:

        m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
        p = p - lr * ((m / bc1) / (sqrt(v / bc2) + eps) [+ wd p])

    with bc = 1 - b^t in float32, as the JAX update computes them."""
    mu, nu = list(opt.mu.values()), list(opt.nu.values())
    if not (len(grads) == len(params) == len(mu)):
        raise ValueError(f"adam_update: {len(grads)} grads, {len(params)} "
                         f"params, {len(mu)} moments")
    opt.step += 1
    t = np.float32(opt.step)
    bc1 = float(np.float32(1.0) - np.power(np.float32(b1), t))
    bc2 = float(np.float32(1.0) - np.power(np.float32(b2), t))
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b1))
    torch._foreach_mul_(nu, b2)
    torch._foreach_add_(nu, torch._foreach_mul(
        torch._foreach_mul(grads, grads), 1.0 - b2))
    den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
    torch._foreach_add_(den, eps)
    update = torch._foreach_div(torch._foreach_div(mu, bc1), den)
    if weight_decay > 0.0:
        for u, p in zip(update, params):
            if p.dim() >= 2:  # decay kernels, not biases
                u.add_(weight_decay * p)
    torch._foreach_sub_(list(params), torch._foreach_mul(update, lr))


def lr_at_epoch(base_lr: float, epoch: int, decay: float = 0.8,
                every: int = 50) -> float:
    """lr * decay ** (epoch // every), epochs 0-based (the reference's
    lr_scheduler, models/CvT(Par).py:357-360)."""
    return base_lr * (decay ** (epoch // every))
