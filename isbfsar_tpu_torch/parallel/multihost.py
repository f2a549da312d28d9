"""The dp certificate over several nodes (port of
``isbfsar_tpu/parallel/multihost.py``).

``multihost_dp_parity(num_processes, local_devices)`` starts
``num_processes`` x ``local_devices`` ranks (``launch.run_ranks``), each
with torchrun's node environment (``GROUP_RANK``/``NODE_RANK`` for its
node, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``RANK``, ``WORLD_SIZE``), so
the group stands for ``num_processes`` hosts of ``local_devices`` devices.
Every rank builds the same host batch from its seed and keeps only its own
rows (``mesh.shard_batch``), so the only traffic across nodes in the step
is the gradient all-reduce. Each rank runs the global DDP step and a
1-device step of the whole batch and holds one against the other (2e-6);
the report says how many nodes the batch's rows spanned and how many
shards each node held.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Dict

from isbfsar_tpu_torch.parallel.launch import run_ranks

ATOL = 2e-6


def _rank_main(device: str) -> Dict:
    import torch
    import torch.distributed as dist

    from isbfsar_tpu_torch.configs import ARConfig
    from isbfsar_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from isbfsar_tpu_torch.parallel.parity import _step, max_diff, one_device_step
    from isbfsar_tpu_torch.train.synthetic import episodic_batch
    from isbfsar_tpu_torch.train.trainer import Trainer

    n_global = dist.get_world_size()
    node = int(os.environ["GROUP_RANK"])
    cfg = dataclasses.replace(ARConfig.for_input("skeleton"), batch_size=n_global,
                              n_task=n_global, eval_every_n_epoch=10_000)
    batch = episodic_batch(cfg, n_global, 32, "skeleton", seed=0)
    mesh = make_mesh(device=device)
    own = shard_batch(batch, mesh)
    # which node holds each row of the batch: each rank names its rows' node
    nodes = torch.full((own["target_class"].shape[0],), float(node))
    parts = [torch.empty_like(nodes) for _ in range(n_global)]
    dist.all_gather(parts, nodes)
    spanned = len(set(torch.cat(parts).tolist()))
    local_shards = sum(1 for p in parts if p.numel() and float(p[0]) == node)

    with tempfile.TemporaryDirectory() as root:
        many = _step(Trainer(cfg, log_dir=root, use_wandb=False, seed=0, device=device,
                             mesh=mesh), batch)
    one = one_device_step(cfg, batch, device)
    report = {
        "max_param_diff": max_diff(many["params"], one["params"]),
        "max_metric_diff": abs(many["summary"]["train/fs_loss"] - one["summary"]["train/fs_loss"]),
        "num_processes": int(os.environ["NUM_NODES"]),
        "global_devices": n_global,
        "batch_processes_spanned": spanned,
        "local_shards": local_shards,
        "rows_held": int(own["target_class"].shape[0]),
    }
    assert report["max_param_diff"] <= ATOL and report["max_metric_diff"] <= ATOL, (
        f"multi-node dp parity violated: {report}")
    return report


def multihost_dp_parity(num_processes: int = 2, local_devices: int = 2, device: str = "cpu",
                        timeout: float = 300.0) -> Dict:
    """Run the multi-node dp certificate; returns rank 0's report."""
    world = num_processes * local_devices
    env = [{"GROUP_RANK": str(r // local_devices), "NODE_RANK": str(r // local_devices),
            "LOCAL_RANK": str(r % local_devices), "LOCAL_WORLD_SIZE": str(local_devices),
            "RANK": str(r), "WORLD_SIZE": str(world), "NUM_NODES": str(num_processes)}
           for r in range(world)]
    reports = run_ranks(_rank_main, world, device, timeout, device, env=env)
    for r, rep in enumerate(reports):
        assert rep["batch_processes_spanned"] == num_processes, (r, rep)
        assert rep["local_shards"] == local_devices, (r, rep)
    return reports[0]
