"""The port's LM training on the CUDA card against the CPU. Every test
carries the ``cuda`` marker and skips without a card; on one:

    python -m pytest -q -m cuda tests/test_torch_train_cuda.py

* three TINY steps on the card and on the CPU from the same weights and
  batches, f32 with TF32 off, AdamW and Adafactor: the losses within rtol
  1e-5, the params under ``chip_smoke.train_param_diff``'s rule (entries
  outside 1e-6 + 1e-4 |p| under 0.1% of all, each within 2 lr (1 + wd));
* ``launch.train.main`` trains TINY on the card with no device flag.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import train
from repro_torch.launch.train import TINY
from repro_torch.models import registry
from repro_torch.train import tree as T
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_step import make_opt_init, make_train_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: trains on the card against the CPU")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _to(tree, device):
    return T.map_leaves(lambda x: x.to(device), tree)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_tiny_train_step_card_against_cpu(card, opt):
    lr, wd = chip_smoke.TRAIN_LR, chip_smoke.TRAIN_WD
    opt_cfg = OptimizerConfig(name=opt, lr=lr, warmup_steps=0,
                              weight_decay=wd)
    cpu = registry.init_params(TINY, torch.Generator().manual_seed(0))
    sides = {"cpu": [cpu, make_opt_init(TINY, opt_cfg)(cpu)],
             "cuda": [_to(cpu, card), make_opt_init(TINY, opt_cfg)(
                 _to(cpu, card))]}
    step_fn = make_train_step(TINY, opt_cfg)
    pipe = TokenPipeline(DataConfig(vocab=TINY.vocab, seq_len=64,
                                    global_batch=8))
    for i in range(3):
        batch = {k: torch.from_numpy(v) for k, v in pipe.batch_at(i).items()}
        losses = {}
        for dev, side in sides.items():
            side[0], side[1], m = step_fn(side[0], side[1], _to(batch, dev))
            losses[dev] = float(m["loss"])
        assert losses["cuda"] == pytest.approx(losses["cpu"], rel=1e-5)
    diff = chip_smoke.train_param_diff(
        np, {k: v.cpu().numpy() for k, v in T.items(sides["cuda"][0])},
        {k: v.numpy() for k, v in T.items(sides["cpu"][0])}, lr, wd)
    assert diff["ok"], diff


def test_driver_trains_on_the_card(card, tmp_path, capsys):
    assert train.main(["--preset", "tiny", "--steps", "3", "--seq", "32",
                       "--batch", "4", "--ckpt-dir", str(tmp_path)]) == 0
    assert "done in" in capsys.readouterr().out
