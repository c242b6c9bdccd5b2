"""Faults planted under the timed path, to show that ``correct`` catches
them (the tests run them at tiny sizes on the CPU; ``calibrate.py`` reads
them on the card at the cells' sizes).  Each is a context manager that
patches the program and restores it:

- ``frozen_state``: every AdamW update of the program does nothing, so a
  step returns its state unchanged;
- ``half_batch``: the train steps see only the first half of each batch,
  the mean taken over it;
- ``altered_answer``: the first logit of the first clip of every forward
  is moved by 1;
- ``top_layer_decay``: the parameter groups at the top of the layer decay
  (the head and the final norm) take the next layer's learning rate, as an
  off-by-one in the layer ids would give them: a wrong update of a few
  leaves, which the median leaf does not see.

The exchange between chips is not a fault these one-card cells can have.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, name, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def frozen_state():
    return _patched(torch.optim.AdamW, "step",
                    lambda orig: lambda self, closure=None: None)


@contextlib.contextmanager
def half_batch():
    from tpat_tpu_torch.engine.train import TrainModule
    from tpat_tpu_torch.models.mae import MaskedAutoencoderViT

    def vit(orig):
        def loss_and_grads(self, state, x, y, *a, **k):
            h = x.shape[0] // 2
            return orig(self, state, x[:h], y[:h], *a, **k)
        return loss_and_grads

    def mae(orig):
        def forward(self, imgs, *a, **k):
            return orig(self, imgs[:imgs.shape[0] // 2], *a, **k)
        return forward

    with _patched(TrainModule, "loss_and_grads", vit), \
            _patched(MaskedAutoencoderViT, "forward", mae):
        yield


@contextlib.contextmanager
def altered_answer():
    from tpat_tpu_torch.models.vit import AudioViT

    def make(orig):
        def forward(self, *a, **k):
            out = orig(self, *a, **k).clone()
            out[0, 0] += 1.0
            return out
        return forward

    with _patched(AudioViT, "forward", make):
        yield


def top_layer_decay():
    from tpat_tpu_torch.engine import optimizer

    def make(orig):
        def set_lr(opt, lr):
            orig(opt, lr)
            scales = sorted({g["lr_scale"] for g in opt.param_groups})
            if len(scales) > 1:
                for g in opt.param_groups:
                    if g["lr_scale"] == scales[-1]:
                        g["lr"] = lr * scales[-2]
        return set_lr

    return _patched(optimizer, "set_lr", make)


FAULTS = {"frozen_state": frozen_state, "half_batch": half_batch,
          "altered_answer": altered_answer,
          "top_layer_decay": top_layer_decay}
# the faults each kind of cell can have
CELL_FAULTS = {"finetune": ("frozen_state", "half_batch", "top_layer_decay"),
               "pretrain": ("frozen_state", "half_batch"),
               "serve": ("altered_answer",)}
