"""The rank body of ``test_torch_sharding.py``'s model-parallel checks: a
reduced config's loss, MoE metrics and gradients computed with DTensor
parameters of ``param_specs``'s placements on a real gloo (data, model)
mesh with the dry run's logical rules installed, next to the plain
one-process port on the same weights and tokens.

A helper module (no jax import), so that the spawned ranks import it
alone."""
import dataclasses
import json
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

BATCH, SEQ, CHUNK = 2, 64, 32


def _batch(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.as_tensor(
                 rng.integers(0, cfg.vocab_size, (BATCH, SEQ))),
             "loss_mask": torch.as_tensor(
                 (rng.random((BATCH, SEQ)) < 0.9).astype(np.float32))}
    if cfg.is_encdec:
        batch["audio_embed"] = torch.as_tensor(rng.standard_normal(
            (BATCH, cfg.encoder_len, cfg.d_model)).astype(np.float32))
    return batch


def _loss_and_grads(model, batch) -> tuple:
    loss, metrics = model.loss(batch, remat="none", attn_chunk=CHUNK)
    loss.backward()
    return loss, metrics, dict(model.named_parameters())


def _full(t) -> np.ndarray:
    t = t.full_tensor() if hasattr(t, "full_tensor") else t
    return t.detach().double().numpy()


def mesh_rank(rank: int, world: int, port: int, data: int, cases: list,
              out: str) -> None:
    """Rank ``rank`` of a gloo group of ``world`` on a ``(data, world //
    data)`` mesh: for each ``(arch, config overrides)`` of ``cases``, the
    mesh run's loss, metrics and gradients gathered whole, and rank 0
    writes each one's largest error against the plain run, relative to
    that leaf's largest magnitude, to ``out`` as JSON."""
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import Model
    from repro_torch.models.partitioning import logical_axis_rules

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = make_debug_mesh(data, world // data, device_type="cpu")
        report = {}
        for i, (arch, over) in enumerate(cases):
            cfg = dataclasses.replace(get_config(arch, reduced=True),
                                      compute_dtype="float32", **over)
            batch = _batch(cfg, seed=i)
            plain = Model(cfg, device="cpu").init(seed=i)
            p_loss, p_metrics, p_params = _loss_and_grads(plain, batch)

            model = Model(cfg, device="cpu").init(seed=i)
            sh = shd.as_named(mesh, shd.param_specs(
                cfg, model.named_parameters(), mesh))
            dryrun._place_params(model, sh)
            shape = ShapeConfig("t", SEQ, BATCH, "train")
            bsh = shd.as_named(mesh, shd.batch_specs(cfg, shape, mesh))
            placed = {k: distribute_tensor(v, bsh[k].mesh, bsh[k].placements,
                                           src_data_rank=None)
                      for k, v in batch.items()}
            rules = shd.logical_rules(cfg, mesh, batch_size=BATCH,
                                      seq_len=SEQ)
            rules.update(dryrun.PORT_RULES)
            with logical_axis_rules(mesh, rules), implicit_replication():
                loss, metrics, params = _loss_and_grads(model, placed)
            errs = {"loss": abs(float(_full(loss)) - float(p_loss))
                    / abs(float(p_loss))}
            for k, v in p_metrics.items():
                errs[f"metric/{k}"] = abs(float(_full(metrics[k]))
                                          - float(v)) / max(abs(float(v)),
                                                            1e-30)
            sharded = 0
            for name, p in p_params.items():
                q = params[name]
                sharded += any(pl.is_shard() for pl in q.placements)
                want = p.grad.detach().double().numpy()
                got = _full(q.grad)
                errs[f"grad/{name}"] = float(
                    np.abs(got - want).max() / np.abs(want).max())
            if rank == 0:
                report[f"{arch}{over or ''}"] = {
                    "errs": errs, "sharded_params": sharded,
                    "experts": rules.get("experts"),
                    "moe_ffn": rules.get("moe_ffn")}
        if rank == 0:
            Path(out).write_text(json.dumps(report))
    finally:
        dist.destroy_process_group()
