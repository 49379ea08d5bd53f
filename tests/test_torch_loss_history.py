"""The early train-loss rise, port against reference.

Full-width llama3.2-1b trained on the H100 (``chip_smoke.py`` ``train``,
4 x 128 tokens, AdamW at lr 3e-4) logs a loss that falls, rises at the
third step, then falls again.  This holds the port's first four losses
against the reference's on the same weights and batches, at llama3.2-1b's
real vocab (128256, tied head), its optimizer settings (``OptConfig``
defaults: AdamW, lr 3e-4, b2 0.95, weight decay 0.1, clip 1.0, no
warm-up) and a cut depth and width: one layer at d_model 1024 (4 heads of
256), 2 x 32 tokens a step.  ABFT is off on both sides: on the card a
step under ``--abft auto`` equals the ``--abft off`` step bit for bit
(``chip_smoke.py`` ``train``), and the ABFT-on histories are held
against each other by ``tests/test_torch_train.py``.  At this width the
reference's own history rises at the third step too: AdamW's first
updates move every weight by about lr in a coherent direction, and the
logits' response grows with the width (768 wide, neither rises).  The
rise is the algorithm's, not the port's.

Tolerance: losses within 1e-4 relative (f32; four steps of sums in
another order through a 128256-way softmax and AdamW's normalization).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget, scaled_down as jscaled
from repro.core.protected import ABFTConfig as JABFT
from repro.data.pipeline import DataConfig as JData
from repro.models import build_model
from repro.train.train_step import TrainConfig as JTrainConfig
from repro.train.trainer import Trainer as JTrainer, TrainerConfig as JRCfg
from repro_torch.configs import get_config, scaled_down
from repro_torch.core.protected import ABFTConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.model import Model, params_from_reference
from repro_torch.train.train_step import TrainConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

CUT = dict(n_layers=1, d_model=1024, n_heads=4, n_kv_heads=2, head_dim=256,
           d_ff=4096, vocab_size=128256)
STEPS = 4


def test_four_step_loss_history_matches_reference_and_rises(tmp_path):
    jcfg = jscaled(jget("llama3.2-1b"), **CUT)
    cfg = scaled_down(get_config("llama3.2-1b"), **CUT)
    assert cfg.tie_embeddings and cfg.vocab_size == 128256
    jm = build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_reference(cfg, jax.tree_util.tree_map(np.asarray, jp))
    data = dict(global_batch=2, seq_len=32, vocab_size=cfg.vocab_size)
    jt = JTrainer(jm, jp, JTrainConfig(), JData(**data),
                  JRCfg(steps=STEPS, ckpt_every=10 ** 9,
                        ckpt_dir=str(tmp_path / "j")),
                  abft=JABFT(enabled=False))
    del jp
    jh = [h["loss"] for h in jt.run()]
    del jt
    tt = Trainer(Model(cfg), tp, TrainConfig(), DataConfig(**data),
                 TrainerConfig(steps=STEPS, ckpt_every=10 ** 9,
                               ckpt_dir=str(tmp_path / "t")),
                 abft=ABFTConfig(enabled=False),
                 device="cpu")
    th = [h["loss"] for h in tt.run()]
    np.testing.assert_allclose(th, jh, rtol=1e-4)
    # both fall, rise at the third step, and fall again
    for hist in (jh, th):
        assert hist[1] < hist[0] and hist[2] > hist[1] and hist[3] < hist[2]
