"""The params-only FFN baseline (transformer_stm_tpu/models/ffn.py;
reference models/FFN(OnlyPar).py:55-67): Dense(hidden, relu) ->
Dense(hidden, relu) -> Dense(num_classes) on the 5 process parameters.

    model = init_ffn(5, 256, 1, torch.Generator().manual_seed(0))
    out = ffn_forward(model, proc)                 # (B, num_classes)

Its parameters are named as the JAX tree's leaves (``fc1.kernel``,
``fc2.bias``, ``final.kernel``, ...), so train/checkpoint.py maps them by a
rename.  It runs no kernel of its own: three products and two ReLUs.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.common import Dense


class FFN(nn.Module):
    def __init__(self, proc_dim: int = 5, hidden: int = 256,
                 num_classes: int = 1, generator=None):
        super().__init__()
        self.fc1 = Dense(proc_dim, hidden, generator)
        self.fc2 = Dense(hidden, hidden, generator)
        self.final = Dense(hidden, num_classes, generator)

    def forward(self, proc):
        x = torch.relu(self.fc1(proc))
        x = torch.relu(self.fc2(x))
        return self.final(x)


def init_ffn(proc_dim: int, hidden: int, num_classes: int,
             generator: torch.Generator, device="cuda") -> FFN:
    """Glorot-uniform kernels and zero biases drawn from ``generator``, a
    CPU generator, as ``init_cvt`` draws them."""
    return FFN(proc_dim, hidden, num_classes, generator).to(device)


def ffn_forward(model: FFN, proc):
    """proc: (B, proc_dim) -> (B, num_classes)."""
    return model(proc)
