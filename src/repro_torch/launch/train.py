"""Training launcher (twin of ``repro.launch.train``).

    python -m repro_torch.launch.train --steps 20 --batch 4 --seq 128
    python -m repro_torch.launch.train --smoke --device cpu --steps 6

The first trains InternLM2-1.8B at full width on the card (``--device
cuda``, the default); the second its reduced twin with the kernels'
plain versions on the CPU.  ``--arch`` takes every registered config:
the dense ones, among them ``hubert-xlarge`` (audio frames in, the
encoder's one entry point: the serve launcher refuses it) and
``llava-next-34b`` (patch embeddings ahead of the text, the loss on the
text), the MoE configs ``qwen2-moe-a2.7b`` and ``phi3.5-moe-42b-a6.6b``
(loss ``ce + 0.01·aux``), ``xlstm-1.3b`` and ``jamba-v0.1-52b``; the
pipeline draws each config's batch dict as the reference does.  With
AdamW state at full depth the MoE configs and Jamba do not fit one
card's 80 GB (Qwen1.5-MoE-A2.7B alone holds 14.3e9 parameters): they
train reduced (``--smoke``), since the launcher has no depth option, as
the reference's has none; ``chip_smoke.py`` phase 13 trains their first
layers at published widths.

``--inject-fault S`` raises a ``RestartSignal`` at step S, so the run
restores its newest checkpoint and replays from there; ``--resume`` starts from the newest checkpoint
in ``--ckpt-dir``.  ``--summa PxQ`` (default: the arch's
``summa_grid``) runs the SUMMA self-check at the config's
tile/policy/format set on a P×Q grid of spawned ranks before training
(``core.summa.config_selfcheck``: nccl when P·Q cards are visible, else
gloo) and prints its report.  ``--devices N`` bounds the ranks that
self-check may spawn: a grid of more than N ranks raises the mesh's
descriptive error (``launch.mesh._require_devices``), as the reference's
``make_grid_mesh`` does under its forced host-device count.  ``--mesh``
is parsed and not read, as in the reference, whose trainer runs on one
device: there is no data-parallel trainer in either package.
"""
import argparse
import os
import tempfile


def _parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true",
                    help="train the reduced config (reduced(cfg, tp=2))")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--formats", default="",
                    help="override the arch's mixed-precision format set, "
                         "e.g. fp8_e4m3+bf16+fp32 or the short form q:s:d")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--inject-fault", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda or cpu)")
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks the --summa self-check may spawn (0: any)")
    ap.add_argument("--mesh", default="", help="e.g. 2x2 (data x model); "
                    "parsed, not read (as in the reference)")
    ap.add_argument("--summa", default="",
                    help="P x Q grid of the SUMMA self-check, e.g. 2x2 "
                         "(default: the arch's summa_grid)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _parse(argv)

    import dataclasses

    import torch

    from repro_torch.checkpoint import ckpt as CK
    from repro_torch.configs import get, reduced
    from repro_torch.core.formats import FormatSet
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.runtime.fault import RestartSignal
    from repro_torch.train.trainer import TrainerConfig, train

    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --device cpu to train "
                             "with the kernels' plain versions")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = get(args.arch)
    if args.smoke:
        cfg = reduced(cfg, tp=2)
    if args.formats:
        cfg = dataclasses.replace(
            cfg, mp_formats=FormatSet.parse(args.formats).key())
    grid = (tuple(int(v) for v in args.summa.lower().split("x"))
            if args.summa else cfg.summa_grid)
    if grid:
        # validate the distributed SUMMA path at this config's
        # tile/policy/format set before training starts
        from repro_torch.core.summa import config_selfcheck
        if args.devices:
            from repro_torch.launch.mesh import _require_devices
            _require_devices(grid[0] * grid[1],
                             f"make_grid_mesh({grid[0]}x{grid[1]})",
                             have=args.devices)
        rep = config_selfcheck(cfg, grid, device=args.device)
        print(f"SUMMA self-check {rep['grid']} [{rep['formats']}]: "
              f"local path {rep['local_path']} ({rep['plan_source']}), "
              f"rel err {rep['rel_err']:.2e}, "
              f"wire {rep['wire_bytes_per_elem']:.2f} B/elem")
    ocfg = adamw.AdamWConfig(lr_peak=args.lr, warmup_steps=min(
        20, args.steps // 5), total_steps=args.steps)

    injector = None
    if args.inject_fault >= 0:
        fired = {"done": False}

        def injector(step, fired=fired):
            if step == args.inject_fault and not fired["done"]:
                fired["done"] = True
                raise RestartSignal("CLI-injected fault")

    tcfg = TrainerConfig(
        steps=args.steps, seq_len=args.seq, global_batch=args.batch,
        microbatches=args.microbatches, ckpt_dir=args.ckpt_dir,
        ckpt_every=max(10, args.steps // 5), log_every=5, seed=args.seed,
        heartbeat_path=os.path.join(args.ckpt_dir, "heartbeat.json"),
        fault_injector=injector, device=args.device)

    params = opt = None
    start = 0
    if args.resume:
        latest = CK.AsyncCheckpointer(args.ckpt_dir).latest()
        if latest:
            params = T.init_model(torch.Generator(
                device=args.device).manual_seed(args.seed), cfg)
            opt = adamw.init(params, ocfg)
            restored, man = CK.restore(latest,
                                       {"params": params, "opt": opt})
            params, opt = restored["params"], restored["opt"]
            start = man["step"]
            print(f"resumed from {latest} at step {start}")

    params, opt, hist = train(cfg, ocfg, tcfg, params=params,
                              opt_state=opt, start_step=start)
    if not hist:
        print(f"done: nothing to run (step {start} of {args.steps})")
        return 0
    losses = [h["loss"] for h in hist]
    print(f"done: {len(hist)} steps, loss {losses[0]:.4f} → "
          f"{losses[-1]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
