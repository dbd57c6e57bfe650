"""The rank body of ``test_torch_model_parallel.py``'s checks: a reduced
config's loss, MoE metrics and gradients computed with DTensor parameters
of ``param_specs``'s placements on a real gloo mesh ((data, model) or
(pod, data, model)) with the dry run's logical rules installed, next to
the plain one-process port on the same weights and tokens.

A helper module (no jax import), so that the spawned ranks import it
alone."""
import dataclasses
import json
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

SEQ, CHUNK = 64, 32


def _batch(cfg, batch_size: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.as_tensor(
                 rng.integers(0, cfg.vocab_size, (batch_size, SEQ))),
             "loss_mask": torch.as_tensor(
                 (rng.random((batch_size, SEQ)) < 0.9).astype(np.float32))}
    if cfg.is_encdec:
        batch["audio_embed"] = torch.as_tensor(rng.standard_normal(
            (batch_size, cfg.encoder_len, cfg.d_model)).astype(np.float32))
    return batch


def _loss_and_grads(model, batch) -> tuple:
    loss, metrics = model.loss(batch, remat="none", attn_chunk=CHUNK)
    loss.backward()
    return loss, metrics, dict(model.named_parameters())


def _full(t) -> np.ndarray:
    t = t.full_tensor() if hasattr(t, "full_tensor") else t
    return t.detach().double().numpy()


def mesh_rank(rank: int, world: int, port: int, mesh_shape: tuple,
              mesh_axes: tuple, batch_size: int, cases: list,
              out: str) -> None:
    """Rank ``rank`` of a gloo group of ``world`` on a ``mesh_shape`` mesh
    named ``mesh_axes``: for each ``(arch, config overrides)`` of
    ``cases``, the mesh run's loss, metrics and gradients (batch
    ``batch_size`` x ``SEQ``) gathered whole, and rank 0 writes each one's
    largest error against the plain run, relative to that leaf's largest
    magnitude, and the rules used, to ``out`` as JSON."""
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.models.partitioning import logical_axis_rules

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh("cpu", tuple(mesh_shape), tuple(mesh_axes))
        report = {}
        for i, (arch, over) in enumerate(cases):
            cfg = dataclasses.replace(get_config(arch, reduced=True),
                                      compute_dtype="float32", **over)
            batch = _batch(cfg, batch_size, seed=i)
            model = Model(cfg, device="cpu").init(seed=i)
            sh = shd.as_named(mesh, shd.param_specs(
                cfg, model.named_parameters(), mesh))
            dryrun._place_params(model, sh)
            shape = ShapeConfig("t", SEQ, batch_size, "train")
            bsh = shd.as_named(mesh, shd.batch_specs(cfg, shape, mesh))
            placed = {k: distribute_tensor(v, bsh[k].mesh, bsh[k].placements,
                                           src_data_rank=None)
                      for k, v in batch.items()}
            rules = shd.logical_rules(cfg, mesh, batch_size=batch_size,
                                      seq_len=SEQ)
            with logical_axis_rules(mesh, rules), implicit_replication():
                loss, metrics, params = _loss_and_grads(model, placed)
            # gathered whole on every rank (collectives); compared on rank 0
            got = {"loss": _full(loss)}
            got.update({f"metric/{k}": _full(v) for k, v in metrics.items()})
            got.update({f"grad/{n}": _full(q.grad) for n, q in params.items()})
            if rank:
                continue
            plain = Model(cfg, device="cpu").init(seed=i)
            p_loss, p_metrics, p_params = _loss_and_grads(plain, batch)
            errs = {"loss": abs(float(got["loss"]) - float(p_loss))
                    / abs(float(p_loss))}
            for k, v in p_metrics.items():
                errs[f"metric/{k}"] = abs(float(got[f"metric/{k}"])
                                          - float(v)) / max(abs(float(v)),
                                                            1e-30)
            for name, p in p_params.items():
                want = p.grad.detach().double().numpy()
                errs[f"grad/{name}"] = float(
                    np.abs(got[f"grad/{name}"] - want).max()
                    / np.abs(want).max())
            report[f"{arch}{over or ''}"] = {
                "errs": errs,
                "sharded_params": sum(
                    any(pl.is_shard() for pl in q.placements)
                    for q in params.values()),
                "experts": rules.get("experts"),
                "moe_ffn": rules.get("moe_ffn"),
                "attn_q_seq": rules.get("attn_q_seq"),
                "heads": rules.get("heads"),
                "kv_heads": rules.get("kv_heads"),
                "batch": rules.get("batch")}
        if rank == 0:
            Path(out).write_text(json.dumps(report))
    finally:
        dist.destroy_process_group()
