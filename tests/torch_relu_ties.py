"""ReLU ties in the skeleton recognizer's train step, the readings behind
``chip_smoke.py``'s ``RELU_TIE`` (phase 7).

    python -m tests.torch_relu_ties [--epochs N] [--card]

Both parts run the production ``ARConfig`` (batch 32) on phase 7's
synthetic training tree and loader, from the init phase 7 compares.

- On the CPU, over ``--epochs`` epochs of 5 steps: how many inputs of the
  four ReLUs (the skeleton MLP's two layers and the discriminator's first
  two) a step puts within 1e-6 and 1e-5 of zero, and how far one step's
  parameters move when the input nearest zero in one layer (and its second
  and third nearest) is moved to the other side of zero.
- With ``--card``: the card against the CPU on the same batches, per set
  of 5 batches. Each step from the card's state: the ReLU inputs the two
  put on either side of zero and the largest difference between the two
  runs' ReLU inputs. Free-running over the 5 steps, as phase 7 runs them:
  the parameters' largest difference after them and fs_loss's in any step.
"""

import argparse
import os
import sys
import tempfile

import torch

import chip_smoke as smoke
from isbfsar_tpu_torch.configs import ARConfig
from isbfsar_tpu_torch.train.dataloader import EpisodicSampler, batch_iterator
from isbfsar_tpu_torch.train.trainer import Trainer

LAYERS = ("sk.fc1", "sk.fc2", "disc.fc1", "disc.fc2")


def record(model, seen: dict) -> list:
    """Hooks appending each ReLU input (on the CPU) to ``seen[layer]``."""
    return [m.register_forward_hook(
        lambda mod, args, out, name=name: seen[name].append(out.detach().cpu())) for name, m in
        zip(LAYERS, smoke.relu_inputs(model))]


def params_diff(a, b) -> float:
    sb = b.model.state_dict()
    return max(float((v.cpu() - sb[n].cpu()).abs().max())
               for n, v in a.model.state_dict().items())


def near_zero(cfg, batches, root):
    trainer = Trainer(cfg, log_dir=os.path.join(root, "near"), use_wandb=False, seed=1,
                      device="cpu")
    seen = {name: [] for name in LAYERS}
    record(trainer.model, seen)
    counts = {name: [0, 0] for name in LAYERS}
    state = flip_at = None
    for i, batch in enumerate(batches):
        if i == 2:
            state, flip_at = trainer.state(), batch
        for rec in seen.values():
            rec.clear()
        trainer.step(batch)
        for name, rec in seen.items():
            for out in rec:
                counts[name][0] += int((out.abs() < 1e-6).sum())
                counts[name][1] += int((out.abs() < 1e-5).sum())
    for name, (c6, c5) in counts.items():
        print(f"{name}: {c6 / len(batches):.2f} inputs a step within 1e-6 of zero, "
              f"{c5 / len(batches):.2f} within 1e-5")

    def step(layer=None, k=0):
        t = Trainer(cfg, log_dir=os.path.join(root, "flip"), use_wandb=False, seed=1,
                    device="cpu")
        t.load_state(state)
        if layer is not None:
            calls = [0]

            def flip(mod, args, out):
                calls[0] += 1
                if calls[0] > 1:
                    return None
                mask = torch.zeros(out.numel(), dtype=torch.bool)
                mask[torch.argsort(out.detach().abs().flatten())[k]] = True
                return out - 2 * out.detach() * mask.view(out.shape)

            smoke.relu_inputs(t.model)[LAYERS.index(layer)].register_forward_hook(flip)
        t.step(flip_at)
        return t

    plain = step()
    for layer in LAYERS:
        moved = [params_diff(step(layer, k), plain) for k in range(3)]
        print(f"{layer}: the 1st, 2nd and 3rd nearest zero flipped in one step's first pass "
              f"move the parameters by " + ", ".join(f"{m:.3g}" for m in moved))


def card_against_cpu(cfg, batches, root):
    for n in range(len(batches) // 5):
        sets = batches[5 * n: 5 * n + 5]
        forced = {d: Trainer(cfg, log_dir=os.path.join(root, f"f{n}{d}"), use_wandb=False,
                             seed=1, device=d) for d in ("cuda", "cpu")}
        splits, widest = 0, 0.0
        for batch in sets:
            forced["cpu"].load_state(forced["cuda"].state())
            seen = {d: {name: [] for name in LAYERS} for d in forced}
            hooks = [h for d, t in forced.items() for h in record(t.model, seen[d])]
            for t in forced.values():
                t.step(batch)
            for h in hooks:
                h.remove()
            for name in LAYERS:
                for a, b in zip(seen["cuda"][name], seen["cpu"][name], strict=True):
                    splits += int(((a > 0) != (b > 0)).sum())
                    widest = max(widest, float((a - b).abs().max()))
        free = {d: Trainer(cfg, log_dir=os.path.join(root, f"r{n}{d}"), use_wandb=False,
                           seed=1, device=d) for d in ("cuda", "cpu")}
        fs = 0.0
        for batch in sets:
            got = {d: float(t.step(batch)["fs_loss"].detach()) for d, t in free.items()}
            fs = max(fs, abs(got["cuda"] - got["cpu"]))
        print(f"batches {5 * n}-{5 * n + 4}, each step from the card's state: {splits} ReLU "
              f"inputs split, the inputs at most {widest:.3g} apart; free-running: parameters "
              f"{params_diff(free['cuda'], free['cpu']):.3g} apart after 5 steps, fs_loss at "
              f"most {fs:.3g}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--card", action="store_true")
    args = ap.parse_args(argv)
    if args.card and not torch.cuda.is_available():
        print("--card: no CUDA device", file=sys.stderr)
        return 1
    cfg = ARConfig(n_task=smoke.TRAIN_N_TASK)
    with tempfile.TemporaryDirectory() as root:
        train, _ = smoke.train_trees(root)
        sampler = EpisodicSampler(train, k=cfg.way, n_task=cfg.n_task, l=cfg.seq_len, seed=0)
        batches = [b for e in range(args.epochs)
                   for b in batch_iterator(sampler, cfg.batch_size, seed=e)]
        near_zero(cfg, batches, root)
        if args.card:
            card_against_cpu(cfg, batches, root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
