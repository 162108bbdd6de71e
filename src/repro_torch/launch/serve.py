"""Serving launcher (twin of ``repro.launch.serve``): build a model with
random weights from a seeded ``torch.Generator`` and serve prompts
through the shape-bucketed engine.

    python -m repro_torch.launch.serve --prompts "1 2 3" "4 5" --max-new 8
    python -m repro_torch.launch.serve --smoke --device cpu --stats
    python -m repro_torch.launch.serve --smoke --device cpu --replicas 2 \
        --trace run.jsonl

The first serves InternLM2-1.8B at full width on the card (``--device
cuda``, the default); the second its reduced twin with the kernels'
plain versions on the CPU. ``--arch`` takes every registered config:
``qwen2-moe-a2.7b`` (MoE), ``gemma3-4b`` (local/global attention),
``xlstm-1.3b`` (recurrent cells), ``jamba-v0.1-52b`` (Mamba mixers,
one attention layer in eight, MoE on odd layers) and ``llava-next-34b``
(served on text tokens only, as the reference's engine serves it) serve
in the engine's equal mode, where refill, the prefix cache and chunked
prefill are off; ``hubert-xlarge`` is encoder-only and exits non-zero
with the reference's message. ``phi3.5-moe-42b-a6.6b``,
``jamba-v0.1-52b``, ``llava-next-34b`` and ``llama3-405b`` fit one card
only reduced (``--smoke``): the launcher has no depth option, as the
reference's has none. ``chip_smoke.py`` phases 11 and 12 serve their
first layers at every published width on the card. Every
knob maps onto :class:`repro_torch.serve.ServeConfig`; refill, the paged
prefix cache and chunked prefill are on unless switched off. The engine
resolves every plan and builds the kernels before serving unless
``--no-warmup`` is passed; ``--stats`` prints ``Engine.stats()`` as JSON
after the stream drains.

``--ckpt DIR`` serves the params of a training checkpoint (written by
either package); ``--quantize SPEC`` serves every request through an
activation-aware quantized variant (``repro_torch.quant``).  On an MoE
config the variant calibrates the KSplit linears (attention, the shared
expert, the lm_head) and shares the expert weights with the default
tree, as the reference's does; it serves in equal mode.

``--replicas N`` serves through a :class:`~repro_torch.serve.Cluster` of
N engines sharing the weights (``--quantize`` with it is refused, as the
reference refuses it).  ``--trace PATH`` records a ``repro_torch.obs``
JSONL trace through :func:`repro_torch.configure` and writes its Chrome
export (``PATH`` with ``.trace.json``) after the stream drains.  Exit
status is non-zero if any request was rejected at admission.
"""
import argparse
import json


def _parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced config (reduced(cfg, tp=2))")
    ap.add_argument("--prompts", nargs="*", default=["1 2 3 4", "7 8"])
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0,
                    help="weight seed and the engine's sampling seed")
    ap.add_argument("--buckets", default="",
                    help="comma-separated padded prompt lengths "
                         "(default: ArchConfig.serve_buckets)")
    ap.add_argument("--waste-cap", type=float, default=0.75,
                    help="max padding-waste fraction before a request is "
                         "redirected to a cold exact-length bucket")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip plan resolution and kernel builds before "
                         "serving (unwarmed buckets record misses)")
    ap.add_argument("--no-refill", action="store_true",
                    help="disable mid-decode slot retire-and-refill")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable block-paged prefix-KV reuse")
    ap.add_argument("--no-chunked-prefill", action="store_true",
                    help="serve prompts longer than every bucket through "
                         "exact-length buckets instead of chunked prefill")
    ap.add_argument("--prefix-pages", type=int, default=128,
                    help="page-pool capacity of the paged prefix-KV cache")
    ap.add_argument("--page-tokens", type=int, default=4,
                    help="KV positions per page")
    ap.add_argument("--request-seed", type=int, default=0,
                    help="base seed of the per-request sampling streams "
                         "(request i uses request-seed + i)")
    ap.add_argument("--formats", default="",
                    help="override the arch's mixed-precision format set, "
                         "e.g. fp8_e4m3+bf16+fp32 or the short form q:s:d")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda or cpu)")
    ap.add_argument("--stats", action="store_true",
                    help="print stats() JSON after serving")
    ap.add_argument("--ckpt", default="",
                    help="load the params of a training checkpoint "
                         "directory (the reference's format)")
    ap.add_argument("--quantize", default="",
                    help="serve every request through an activation-aware "
                         "quantized weight variant under this format-set "
                         "spec (e.g. int8:d or int4:int8:d); loud blocks "
                         "stay in the set's HIGH float format")
    ap.add_argument("--quantize-ratio", type=float, default=0.25,
                    help="fraction of K-blocks the calibrator keeps HIGH "
                         "when --quantize is set")
    ap.add_argument("--replicas", type=int, default=1,
                    help="data-parallel engine replicas behind one "
                         "admission front-end (1: a single engine)")
    ap.add_argument("--trace", default="",
                    help="record a repro_torch.obs JSONL trace to this "
                         "path (a Perfetto-loadable .trace.json is "
                         "written beside it)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _parse(argv)
    if args.quantize and args.replicas > 1:
        raise SystemExit("--quantize serves through Engine weight "
                         "variants; not supported with --replicas")

    import dataclasses

    import numpy as np
    import torch

    import repro_torch
    from repro_torch.configs import get, reduced
    from repro_torch.core.formats import FormatSet
    from repro_torch.models import transformer as T
    from repro_torch.serve import Cluster, Engine, Request, ServeConfig

    if args.trace:
        repro_torch.configure(obs_trace=args.trace)

    cfg = get(args.arch)
    if args.smoke:
        cfg = reduced(cfg, tp=2)
    if args.formats:
        cfg = dataclasses.replace(
            cfg, mp_formats=FormatSet.parse(args.formats).key())
    if cfg.encoder_only:
        raise SystemExit(f"{args.arch} is encoder-only: no decode serving")
    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --device cpu to serve "
                             "with the kernels' plain versions")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    params = T.init_model(
        torch.Generator(device=args.device).manual_seed(args.seed), cfg)
    if args.ckpt:
        from repro_torch.checkpoint import ckpt as CK
        restored, man = CK.restore(args.ckpt, {"params": params})
        params = restored["params"]
        print(f"loaded checkpoint step {man['step']}")
    variants, req_tag = None, "default"
    if args.quantize:
        from repro_torch.quant import quantize_params
        qset = FormatSet.parse(args.quantize)
        req_tag = qset.key()
        variants = {req_tag: quantize_params(
            params, fset=qset, ratio_high=args.quantize_ratio)}
        print(f"quantized variant {req_tag} "
              f"(ratio_high={args.quantize_ratio})")
    sc = ServeConfig(
        buckets=(tuple(int(b) for b in args.buckets.split(","))
                 if args.buckets else None),
        waste_cap=args.waste_cap,
        max_batch=args.max_batch,
        max_seq=args.max_seq,
        rng_seed=args.seed,
        refill=not args.no_refill,
        prefix_cache=not args.no_prefix_cache,
        chunked_prefill=not args.no_chunked_prefill,
        prefix_pages=args.prefix_pages,
        page_tokens=args.page_tokens,
        warmup=not args.no_warmup,
        replicas=args.replicas,
    )
    if sc.replicas > 1:
        server = Cluster(cfg, params, sc)
        eng = server.replicas[0]
        where = f"cluster of {sc.replicas} replicas"
    else:
        server = eng = Engine(cfg, params, sc, variants=variants)
        where = "engine"
    print(f"{where} {cfg.name} on {args.device}: mode={eng.mode} buckets="
          f"{sorted(k.pad_len for k in eng.scheduler.buckets)} "
          f"refill={eng.refill_enabled} "
          f"prefix_cache={eng.prefix is not None} "
          f"chunk={eng._chunk or None}")
    if sc.warmup:
        reps = (server.warmup() if sc.replicas > 1
                else {"engine": eng.warmup()})
        for name, rep in reps.items():
            fresh = rep.pop("fresh_resolutions")
            print(f"warmup {name}: {fresh} fresh plan resolutions; "
                  f"paths={ {k: v['paths'] for k, v in rep.items()} }")
    reqs = [Request(np.array([int(t) % cfg.vocab for t in p.split()],
                             np.int64),
                    max_new_tokens=args.max_new,
                    temperature=args.temperature,
                    seed=args.request_seed + i, fset=req_tag)
            for i, p in enumerate(args.prompts)]
    rejected = 0
    for i, r in enumerate(server.generate(reqs)):
        if r.error:
            rejected += 1
            print(f"request {i}: prompt={np.asarray(r.prompt).tolist()} "
                  f"REJECTED — {r.error}")
            continue
        replica = f" replica={r.replica}" if sc.replicas > 1 else ""
        print(f"request {i}: prompt={np.asarray(r.prompt).tolist()} "
              f"→ out={r.out_tokens}  "
              f"[bucket={r.bucket} padded_to={r.padded_to} "
              f"cold={r.cold}{replica} "
              f"latency={r.latency_s * 1e3:.0f}ms]")
    st = server.stats()
    if sc.replicas > 1:
        per = [p["requests"]["served"] for p in st["per_replica"]]
        print(f"served={st['requests']['served']} over {st['healthy']}/"
              f"{st['replicas']} healthy replicas (per replica {per}) "
              f"post_warmup_fresh_resolutions="
              f"{st['post_warmup_fresh_resolutions']}")
    else:
        print(f"served={st['requests']['served']} "
              f"microbatches={st['microbatches']['total']} "
              f"(multi={st['microbatches']['multi_request']}) "
              f"refills={st['microbatches']['refills']} "
              f"chunked_prefills={st['chunked_prefills']} "
              f"hit_rate={st['bucket_hit_rate']:.2f} "
              f"post_warmup_fresh_resolutions="
              f"{st['plans']['post_warmup_fresh_resolutions']}")
    if args.stats:
        print(json.dumps(st, indent=1, sort_keys=True))
    if args.trace:
        from repro_torch.obs.trace import export_chrome
        repro_torch.configure(obs_trace=None, obs=False)  # close the JSONL
        print(f"trace: {args.trace} (chrome: {export_chrome(args.trace)})")
    if rejected:
        raise SystemExit(f"{rejected} request(s) rejected at admission")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
