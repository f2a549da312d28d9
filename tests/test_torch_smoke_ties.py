"""``chip_smoke.py``'s card-against-CPU train steps and their ReLU ties, on
the CPU.

A ReLU whose input lies within rounding of zero can fall on one side on the
card and on the other on the CPU; ``chip_smoke.step_card_then_cpu`` makes
the CPU's step take the card's side of such a tie and fails on a wider
split. Here two CPU trainers from one init stand in for the card and the
CPU, and a hook puts one input of the skeleton MLP's second layer on
opposite sides of zero in the two.
"""

import numpy as np
import pytest
import torch

import chip_smoke as smoke
from isbfsar_tpu_torch.configs import ARConfig
from isbfsar_tpu_torch.train.synthetic import episodic_batch
from isbfsar_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)

CFG = ARConfig.for_input("skeleton", batch_size=2)


def _pin_first_input(trainer, value):
    """Set the first output of the skeleton MLP's second layer to ``value``
    in every forward, keeping its gradient."""

    def hook(mod, args, out):
        mask = torch.zeros(out.shape, dtype=torch.bool)
        mask.view(-1)[0] = True
        return torch.where(mask, out + (value - out.detach()), out)

    trainer.model.sk_extractor.fc2.register_forward_hook(hook)


def _pair(tmp_path, side):
    pair = [Trainer(CFG, log_dir=str(tmp_path / d), use_wandb=False, seed=1, device="cpu")
            for d in ("card", "cpu")]
    for trainer, value in zip(pair, (side, -side)):
        _pin_first_input(trainer, value)
    return pair


def _params_diff(a, b):
    sb = b.model.state_dict()
    return max(float((v - sb[n]).abs().max()) for n, v in a.model.state_dict().items())


def test_the_cpu_takes_the_cards_side_of_a_relu_tie(tmp_path):
    """A tie at 1e-7 moves one step's parameters past TOL_TRAIN when each
    side keeps its own decision; with the card's taken, once in each of the
    step's three passes through the MLP (query, support, unknown), the two
    steps agree."""
    batch = episodic_batch(CFG, CFG.batch_size, CFG.rgb_size, "skeleton", seed=0)
    card, cpu = _pair(tmp_path / "own", 1e-7)
    card.step(batch), cpu.step(batch)
    assert _params_diff(card, cpu) > smoke.TOL_TRAIN["params"]

    card, cpu = _pair(tmp_path / "taken", 1e-7)
    got_card, got_cpu, ties = smoke.step_card_then_cpu(card, cpu, batch)
    assert ties == 3
    for k in ("fs_loss", "os_loss"):
        assert abs(got_card[k] - got_cpu[k]) <= smoke.TOL_TRAIN[k]
    np.testing.assert_array_equal(got_card["fs_correct"], got_cpu["fs_correct"])
    assert _params_diff(card, cpu) <= smoke.TOL_TRAIN["params"]


@pytest.mark.parametrize("side", [1e-3, smoke.RELU_TIE * 1.5])
def test_a_split_wider_than_a_tie_fails(tmp_path, side):
    batch = episodic_batch(CFG, CFG.batch_size, CFG.rgb_size, "skeleton", seed=0)
    card, cpu = _pair(tmp_path, side)
    with pytest.raises(AssertionError, match="on one side on the card"):
        smoke.step_card_then_cpu(card, cpu, batch)
