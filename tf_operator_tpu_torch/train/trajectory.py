"""The loss trajectory that holds the port's training to the JAX package's.

Both packages train the same transformer from the same f32 init
(``models.transformer.init_transformer_numpy``) on the same token batch
(``trajectory_tokens``) with the LM workload's optimizer (AdamW behind a
global-norm clip of 1.0, lr 3e-4), in f32, and record the loss before
each update. ``tests/test_torch_trajectory.py`` generates the JAX
package's losses on the CPU and writes them, with the seeds, the cuts and
the limit, to ``ARTIFACT`` (gqa-2048, causal) and ``BERT_ARTIFACT``
(bert-base, masked LM: JAX's fixed mask recorded by its positions);
``chip_smoke.py`` (phase ``jax_trajectory``) rebuilds the inputs from the
seeds and holds the port's losses on the card to them.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from tf_operator_tpu_torch.compat import params_from_numpy
from tf_operator_tpu_torch.device import DeviceLike, resolve_device
from tf_operator_tpu_torch.models.transformer import TransformerConfig, lm_loss, preset
from tf_operator_tpu_torch.train.trainer import Trainer, TrainerConfig

ARTIFACT = "artifacts/torch_vs_jax_gqa2048.json"
BERT_ARTIFACT = "artifacts/torch_vs_jax_bert_base.json"
LR = 3e-4


def trajectory_config(name: str, **overrides) -> TransformerConfig:
    """The port's side: f32 activations, the flash kernels, save_mid remat
    (the north-star job's attention and remat) unless ``overrides`` say
    otherwise."""
    return preset(name, **{"dtype": torch.float32, "attn_impl": "flash", "remat": "save_mid",
                           **overrides})


def trajectory_mask(shape, positions) -> np.ndarray:
    """A masked-LM mask of ``shape`` from its flat True ``positions`` (how
    an artifact records JAX's)."""
    mask = np.zeros(int(np.prod(shape)), bool)
    mask[np.asarray(positions, np.int64)] = True
    return mask.reshape(shape)


def trajectory_tokens(vocab: int, batch: int, seq: int, seed: int) -> np.ndarray:
    """The batch: ``np.random.RandomState(seed).randint(0, vocab, (batch,
    seq))`` as int32."""
    return np.random.RandomState(int(seed)).randint(0, vocab, (batch, seq)).astype(np.int32)


def port_trajectory(cfg: TransformerConfig, params: dict, tokens: np.ndarray, steps: int,
                    device: DeviceLike = None, mask: Optional[np.ndarray] = None) -> List[float]:
    """The loss before each of ``steps`` updates of the port's Trainer from
    the numpy ``params`` on the batch ``tokens`` (masked-LM models: at the
    positions of ``mask``, bool like ``tokens``)."""
    dev = resolve_device(device)
    mask_t = None if mask is None else torch.from_numpy(np.asarray(mask, bool)).to(dev)
    trainer = Trainer(loss_fn=lambda p, tok, extra: lm_loss(p, tok, cfg, mask=mask_t),
                      init_fn=None,
                      config=TrainerConfig(optimizer="adamw", learning_rate=LR), device=dev)
    state = trainer.state_from_params(params_from_numpy(params, dev))
    batch = torch.from_numpy(tokens).long().to(dev)
    losses = []
    for _ in range(steps):
        state, m = trainer.step(state, batch)
        losses.append(m["loss"])
    return [float(x) for x in losses]
