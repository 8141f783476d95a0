#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mpit_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order, one line each; nothing is caught, so any failure exits
non-zero before the result lines:

1. card    — name and power limit from ``nvidia-smi``.
2. build   — compile every CUDA kernel of the port from ``mpit_tpu_torch/ops/csrc``
             (one ``nvcc`` per source, all started together).
3. wire    — the frame codec: the frozen corpus
             (``tests/fixtures/wire_corpus/corpus.jsonl``) replays through the
             port's decoder with its 400 recorded verdicts, with this machine's
             numpy; LeNet's flat vector, and its bf16 and int8 quantizations,
             round-trip as push frames, timed per encode and decode.
4. native  — build the port's C++ broker with the host compiler (compiler and
             seconds printed) and carry a message over it: it must build, so
             that ``transport="auto"`` means the C++ broker here.
5. kernels — the elastic update against its plain PyTorch version on the
             card, with TF32 off: one leaf at the reference's test shapes,
             then whole lists of leaves in one call (LeNet's 8, the LSTM's
             27, a ragged list whose leaves start off 16-byte boundaries, a
             list longer than one launch takes); a round of LeNet's leaves
             and one of the LSTM's (11,364,112 floats) timed as one launch
             and as one launch per leaf, with CUDA events and device time,
             beside the bound, the plain version and ``lerp`` + ``add``.
6. flash   — both flash-attention families against their plain versions:
             the CUDA-core kernels (forward, dQ, dK/dV) at the reference's
             test cases and the path's shape, called directly; then, through
             the dispatch of the ``autograd.Function``, the tensor-core
             (sm90) forward, dQ and dK/dV at bf16 D = 64 and the path's
             shape, with the counters showing which family each case
             launched; rows no key sees giving dQ = 0; the autograd path
             against dense attention's gradients (a bf16 D = 64 case among
             them), and T = 100 going to dense with no launch. All six
             kernels timed at the path's shape in this one call, by CUDA
             events and device time, beside the bound, the plain version and
             ``scaled_dot_product_attention`` (forward, and its autograd
             backward) as the library yardstick.
7. round   — one EASGD round of an f32 LeNet, W = 8, on the card (kernel)
             against the same round on the CPU (plain version).
8. step    — one sync-DP step of an f32 2-layer flash transformer on the card
             (kernels) against the same step on the CPU (plain versions); the
             flash counts are set to 0 just before and read after. This f32
             path is where the CUDA-core kernels run, so their rows of the
             kernels line take their launches from here.
9. main    — ``run()`` with the ``mnist-easgd`` preset for one epoch, W = 8
             workers stacked on the card, bf16 LeNet; the elastic kernel's
             launch count is set to 0 just before and read just after: one
             launch per round.
10. profile — ``torch.profiler`` over a few of the same rounds: the card's
             busy share and the kernels that take the most time.
11. ps-parity — a 1-client, 1-server ``AsyncPSTrainer`` run of an f32 LeNet
             on the card (EASGD, α = 0.5, τ = 4, 24 steps of batch 32)
             against the collective ``EASGDTrainer`` at W = 1 on the card,
             from the same init and batches: the centers agree within the
             reference's limits, and the collective side launches the
             elastic kernel once per round.
12. ps     — ``run()`` with the ``mnist-ps`` preset at full width (2 client
             threads, 1 server thread, 200 local steps each, τ = 4, bf16
             LeNet) on its ``transport="auto"``, which must resolve to the
             C++ broker: once to warm up, once timed and once under the
             profiler; then one timed run each over ``inproc`` and
             ``socket``. Each is held to the server's counts, finite and
             falling losses and accuracy: samples/s, each client's exchange
             time per round and the card's busy share. The path launches no
             kernel of the port (asserted).
13. ps-chaos — thread mode over ``socket`` at the same width under the
             reference's seeded chaos schedule (drops, duplicates, resets):
             every push applied exactly once, each kind fires, and a second
             run with the seed logs the same faults.
14. ps-proc — process mode: ``python -m mpit_tpu_torch.launch -n 3
             mpit_tpu_torch/examples/ptest_proc.py --preset mnist-ps`` as a
             subprocess with a timeout: exit 0, the server's counts of the
             reference's process mode, no dead client, client 0's accuracy,
             no CUDA context on the server, each client's samples/s; then an
             elastic leg whose server snapshot loads with ``load_shard_state``
             and holds the center its client fetched last.
14b. obs-ps — the same process-mode run with ``MPIT_OBS_DIR``,
             ``MPIT_OBS_LIVE=1`` and the black box armed: every rank's journal,
             black-box dump and live snapshot; ``python -m mpit_tpu_torch.obs``
             on the directory (``merge``, ``summary``, ``roofline --json`` with
             each rank's fractions summing to 1, ``dynamics --json``, ``live
             --validate`` and ``--once --json``, ``postmortem --json`` after a
             ``request_dump``); each rank's telemetry split of the exchange
             per stream and message (send: serialize, queue_wait, write;
             receive: ``rx_phase_s`` transfer and deserialize); samples/s with
             obs on beside ps-proc's with it off.
14c. rt    — the sanitizers: ``mnist-ps`` in threads on the card, 40 steps a
             client, in a process started with ``MPIT_RT_RACE=1
             MPIT_RT_NUMERICS=1``: no finding; one NaN planted into the numpy
             quant face afterwards is exactly one RT104, and the exit report
             counts 0 and 1; the same run without the knobs first, for the
             samples/s the checkers cost.
15. vgg, resnet, lstm, alexnet — BASELINE's other four presets
             (``cifar-vgg-sync``, ``resnet50-sync``, ``ptb-lstm-easgd``,
             ``alexnet-downpour``), each: one f32 step or round on the card
             against the same on the CPU from one init (VGG at full width,
             ResNet (1, 1, 1, 1) at 64², AlexNet at 64², a 2-layer LSTM;
             tolerance 1e-4), three profiled units on random inputs (busy
             share, top kernels; also the warm-up), then ``run()`` at the
             preset's width and ``train_size``: the reference's units and
             samples, finite losses, samples/s (tokens/s for the LSTM), ms
             per unit, elastic launches = rounds on the LSTM (counts set to
             0 just before), and a loss whose last quarter is below its first
             (ResNet and AlexNet in a longer leg: 1024 × 3 epochs, 2048 × 2).
15b. dp-quant — the bucketed and quantized sync-DP exchange (after the
             four BASELINE phases): the quant torch face on the card against
             the numpy face, bit for bit, on random and edge inputs; the
             reference's ``bench_dp`` leg (f32 LeNet, W = 8, 128 per worker,
             SGD 0.05 with momentum 0.9, 64 KiB buckets, 3 warm-up and 60
             timed steps; cuDNN's deterministic algorithms, since the default
             ones make its chaotic trajectory differ run to run) fused, raw
             bucketed, int8 and bf16: samples/s,
             buckets, wire bytes a step (the counts the CPU tests pin), losses
             finite and falling; one f32 int8 bucketed step, card vs CPU; then
             ``resnet50-sync`` through ``run()`` under ``MPIT_DP_QUANT=int8``:
             three profiled steps (busy share, top kernels), samples/s, ms per
             step, peak memory of a training step, buckets and wire bytes, and
             its losses beside the fused run's (the first equal).
16. lm     — ``run()`` with ``ptb-transformer-large --algo sync --attn-impl
             flash`` at full width (6 layers, d_model 768, 12 heads, T = 512,
             global batch 8), one epoch over a cut training set; the flash
             kernels' launch counts are set to 0 just before and read after:
             the sm90 forward, dQ and dK/dV run, the CUDA-core ones do not.
17. lm-profile — ``torch.profiler`` over a few of the same steps: the
             flash family's device time per step, by kernel family.
17a. obs-lm — ``ptb-transformer-large --algo sync`` at full width, 16 steps
             under ``MPIT_DP_QUANT=int8``, untraced, with ``MPIT_OBS_DIR``,
             untraced again (ms a step of each): the bucketed
             step's ``compute`` spans (each ended after a stream
             synchronize), one ``send`` per hop and a ``dynamics`` record a
             step; ``roofline --json`` (compute, wire, idle and overhead
             summing to 1 within 1e-6) and ``dynamics --json``; the sm90 flash
             launches (counts set to 0 just before) join the kernels line.
17b. zero  — ``ptb-transformer-large --algo zero-sync --attn-impl flash`` at
             full width, cut as ``lm`` is (64 steps): tokens/s, ms per step,
             peak memory of a training step, the losses against the ``lm``
             phase's sync run (within ZERO_TOL, and whether equal bit for
             bit), the sm90 flash launches (the ``lm`` phase's counts); then
             16 steps under ``MPIT_DP_QUANT=int8`` (each worker's own
             gradient, the quantized scatter), its launches counted alike.
18. seq    — ``run()`` with ``ptb-transformer-large`` at its own algo,
             seq-sync, full width, W = 8, 64 steps each: (dp, sp) = (8, 1)
             with ring attention, (2, 4) ring, (2, 4) Ulysses; tokens/s, ms
             per step, the peak device memory of a training step, eval
             accuracy and loss, three ring steps under the profiler (busy
             share, top kernels, host time); every loss finite, the last 8
             below the first 8, no kernel of the port launched (the attention is PyTorch
             operations, as the reference's is jnp). Then one f32 step of a
             narrow 2-layer LM (T = 64, D = 16) at (8, 1), (2, 4) ring and (2,
             4) Ulysses: each within the reference's mesh invariance of (8, 1)
             on the card (loss 1e-5, params 5e-5) and within 1e-4 of itself
             on the CPU.
19. remat  — ``--remat`` against the same run without it: 16 steps of
             ``ptb-transformer-large --algo sync --attn-impl flash``, 16 of the
             preset's seq-sync, 8 of ``resnet50-sync``; ms per step and the
             peak device memory of a training step for each, losses within
             1e-5 relative (and whether they are equal bit for bit); the flash
             launches of the remat run (counts set to 0 just before): the sm90
             forward twice a step per layer (recomputed in the backward) plus
             the eval forwards, dQ and dK/dV once.
20. resume-easgd — ``mnist-easgd`` (W = 8, cosine, clip_norm 1.0) two
             epochs straight, checkpointing each epoch, and resumed from a
             copy of the straight run's first-epoch checkpoint (a preempted
             job: the cosine spans the whole run): the final checkpoint
             files are byte-equal, and the resumed leg launches the elastic
             kernel once per round (counts set to 0 just before).
21. resume-lm — the same for the transformer at full width (clip_norm 1.0,
             warmup-cosine, 2 epochs of 16 steps): byte-equal final files
             (about 607 MB each, in a temporary directory), the sm90 flash
             launches of the resumed leg, the checkpoint's size and its save
             and restore times.
22. ps-resume — ``mnist-ps`` with ``ckpt_dir``, then resumed: the second run
             restores the servers' center chunks, both keep the reference's
             counts, and the ``ps_center`` checkpoint loads.
23. profile-dir — one ``mnist-easgd`` epoch with ``profile_dir``: the Chrome
             trace holds the card's kernels, the elastic kernel once a round.
24. dist   — ``python -m mpit_tpu_torch.launch --jax-distributed
             mpit_tpu_torch/examples/multihost_sync.py --algo sync`` with one
             rank on the card (NCCL) and two on the CPU (gloo), and ``--algo
             zero`` with one rank on the card: exit 0, the world's worker
             count, equal losses on every rank, a bit-exact checkpoint round
             trip.
25. serve  — ``ptb-transformer-large``'s model at full width (6 layers,
             d_model 768, 12 heads, max_len 512, vocab 10,000, bf16, seeded
             weights) served: 8 requests through ``Server(max_batch=8,
             segment=16)`` against their solo ``generate_fast``, greedy and
             at temperature 0.8, top_p 0.95: 8 of 8 bit-equal each (ROADMAP
             C8, repaired by the decode path's fixed row blocks); 4 requests
             behind a shared ``prefix=`` against solo calls on prefix +
             prompt (counted; each divergence at a near-tie); the f32
             prefill and first tick's logits, card vs CPU; the load run
             (``LoadHarness`` over 64 requests at 50/s with obs on, read by
             ``python -m mpit_tpu_torch.obs slo``: requests/s, generated
             tokens/s, TTFT and TPOT p50/p99, peak memory against the KV
             cache); one segment timed and profiled (ms and launches a tick,
             busy share, top kernels); each cost beside the one measured
             before the row blocks.
26. serve-spec — the same 8 requests through the speculative server with a
             2-layer, d_model 256 draft, ``spec_k`` 4: tokens against the
             greedy run's (or C8), acceptance, tokens per target read,
             tokens/s.
27. serve-rnn — ``RNNServer`` at ``ptb-lstm-easgd``'s widths over the load
             schedule without the length cap: every result against its solo
             ``generate_rnn`` (or C8); tokens/s.
27b. fleet — the serving fleet (``mpit_tpu_torch.fleet``) over ``serve``'s
             full-width model, replicas ``Server(max_batch=8, segment=16)``,
             16 requests at 25/s (``scripts/fleet_soak.sh``'s shape): (a) 3
             replicas in threads, p2c, a clean run and one with rank 1
             killed at router boundary 30 (a spare, the controller): both
             audits ok with nothing lost, rank 1 dead, redispatches, every
             request's tokens equal across the runs and to its solo
             ``generate_fast``; (b) the soak pair (bf16 weight pushes at
             boundaries 20 and 60, the chaos run with the kill): audits ok
             with monotonic versions, ``pin --expect-kill``, ``obs slo
             --gate scripts/fleet_smoke.json``; tokens/s, e2e and TTFT
             p50/p99, redispatches, peak memory per run; bytes and seconds
             to encode, send and install per push; (c) ``python -m
             mpit_tpu_torch.fleet run --procs`` with the CLI's model on the
             card, clean and with rank 1 SIGKILLed: each replica process has
             its own CUDA context, the kill is detected, the audit is ok;
             tokens/s beside the same CLI in threads and one ``Server``, and
             on a burst of 96 requests at once.
28. generate-flash — the fixed-buffer ``generate`` on the serving model
             built with ``attn_impl="flash"``, 16 greedy tokens: 96 sm90
             forward launches (counts set to 0 just before, read after; they
             join the kernels line's row), the logits within the bf16 model
             limit of the xla model's.
29. conv-determinism — ROADMAP C7: cuDNN's flags back at PyTorch's
             defaults, a tiny ``run()`` (which sets the deterministic
             algorithms), then ``dp-quant``'s fused LeNet leg twice with no
             override: the losses equal bit for bit; one leg with the
             defaults for the cost.

Each phase's seconds follow its lines. Then a JSON line ``{"kernels": [...]}`` and, last, the device line
``{"ok": true, "device": {...}}``. The script uses one card: it hides the
others (``CUDA_VISIBLE_DEVICES``) before CUDA starts, so the device line's
count is the number of cards the run used. Without CUDA it exits 2 and
prints no result. It needs the repository beside it: alone it fails at the
import.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12    # H100 SXM, f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # H100 SXM, bf16 dense tensor cores
TOL = 1e-6                 # the reference's limit for the elastic math (tests/test_ops.py:32)
WORKERS = 8
# the reference's flash tolerances (tests/test_flash_attention.py)
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
FLASH_GRAD_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
LM_SHAPE = (8, 512, 12, 64)  # (B, T, H, D) of ptb-transformer-large's attention
LM_LAYERS = 6
LM_TRAIN_WINDOWS = 512       # 64 steps of global batch 8
# the reference's limits for a 1-client PS run against the collective
# trajectory (tests/test_async_ps.py:157)
PS_TOL = dict(rtol=2e-4, atol=2e-5)
# LeNet's early trajectory at lr 0.05 and momentum 0.9 amplifies a change in
# the last bit to 1e-3 and more at some init seeds, where a max-pool picks
# another element; this seed kept eight draws of such a change at the init
# within 1.2e-7 on the CPU (tests/test_torch_ps.py, which also holds this
# phase's comparison there)
PS_PARITY_SEED = 9


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def one_card(environ) -> str:
    """The card the run uses: the first one CUDA would show."""
    return environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0].strip() or "0"


def device_line(kind: str, count: int) -> dict:
    return {"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", one_card(os.environ),
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    phase("card", out)
    return out


def build() -> None:
    from mpit_tpu_torch.ops import _build

    t0 = time.perf_counter()
    outputs = _build.build_all()
    for name, out in outputs.items():
        kernel = name
        for line in out.splitlines():
            entry = "Compiling entry function" in line and re.search(
                r"([a-z]+_[a-z_]*?_kernel)(?:I(f|13__nv_bfloat16)Li(\d+)E)?", line)
            if entry:
                kname, dtype, width = entry.groups()
                kernel = kname + (f"<{'bf16' if dtype != 'f' else 'f32'}, D<={width}>"
                                  if width else "")
            elif "registers" in line or "spill" in line:
                phase("build", f"{kernel}: {line.strip()}")
    phase("build", f"{len(outputs)} source(s) compiled in "
          f"{time.perf_counter() - t0:.2f} s (set-up)")


def time_ms(fn, reps: int = 50, trials: int = 7) -> float:
    """Median over trials of the mean time of ``reps`` back-to-back calls,
    by CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_ms(fn, reps: int = 20) -> float:
    """Device time per call: the card's kernel time under ``torch.profiler``
    summed over ``reps`` calls, divided by ``reps``. Unlike :func:`time_ms`
    it leaves out the host's launch overhead between small kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a profiler session now and then records no device events (seen once
    # in a run of many sessions): that is no time, so profile again
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
        if total > 0:
            return total / 1e3 / reps
    return float("nan")  # not measured


def elastic_bytes(w: int, n: int) -> int:
    return 4 * (2 * w * n + 3 * n)  # read x, c, d; write new_x, new_c


def elastic_bound_ms(w: int, n: int) -> float:
    by_bytes = elastic_bytes(w, n) / HBM_BYTES_PER_S
    by_ops = (3 * w * n + 2 * n) / F32_FLOPS_PER_S
    return 1e3 * max(by_bytes, by_ops)


def leaf_shapes(name: str) -> list[tuple]:
    """The shape of each parameter leaf of a registry model at its
    preset's width, in leaf order: the leaves of an elastic round (LeNet's
    on the main path, the LSTM's on ``ptb-lstm-easgd``)."""
    from mpit_tpu_torch.models import get_model
    from mpit_tpu_torch.utils.params import tree_leaves

    params = get_model(name, device="cuda").init(torch.Generator().manual_seed(0))
    return [tuple(t.shape) for t in tree_leaves(params)]


LSTM_LEAVES, LSTM_PARAMS = 27, 11_364_112  # ptb-lstm-easgd's tree at vocab 10,000


def elastic_round_times(leaves, alpha: float) -> dict:
    """One round's elastic update over ``leaves`` (xs, cs, ds) as one
    launch, one launch per leaf, the plain version and ``lerp`` + ``add``,
    by CUDA events and by device time, beside the bound."""
    from mpit_tpu_torch.ops import elastic

    xs, cs, ds = leaves
    fns = dict(
        ms=lambda: elastic.elastic_update_leaves(xs, cs, ds, alpha, use_kernel=True),
        per_leaf_ms=lambda: [elastic.elastic_update(x, c, d, alpha, use_kernel=True)
                             for x, c, d in zip(xs, cs, ds)],
        plain_ms=lambda: elastic.elastic_update_leaves(xs, cs, ds, alpha, use_kernel=False),
        library_ms=lambda: [(torch.lerp(x, c, alpha), torch.add(c, d, alpha=alpha))
                            for x, c, d in zip(xs, cs, ds)],
    )
    row = dict(floats=sum(c.numel() for c in cs),
               bound_ms=sum(elastic_bound_ms(WORKERS, c.numel()) for c in cs))
    for k, fn in fns.items():
        row[k] = time_ms(fn)
        row["device_" + k] = device_ms(fn)
    return row


def kernels_vs_plain() -> dict:
    from mpit_tpu_torch.ops import elastic

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("kernels", "TF32 off for matmuls and convolutions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    alpha = 0.9 / WORKERS

    def leaf_list(w, shapes, offset=0):
        """(xs, cs, ds), each leaf a view ``offset`` floats into a buffer of
        its own: an offset that is not a multiple of 4 starts it off a
        16-byte boundary."""
        out = []
        for shape in shapes:
            xs = (w, *shape) if w > 1 else shape
            out.append([torch.randn(offset + torch.Size(s).numel(), generator=gen,
                                    device="cuda")[offset:].view(s)
                        for s in (xs, shape, shape)])
        return [list(t) for t in zip(*out)]

    max_err = 0.0
    lenet, lstm = leaf_shapes("lenet"), leaf_shapes("lstm")
    if (len(lstm), sum(torch.Size(t).numel() for t in lstm)) != (LSTM_LEAVES, LSTM_PARAMS):
        raise AssertionError(f"the LSTM's tree: {len(lstm)} leaves")
    cases = [(s, w) for s in [(7,), (65536,), (65549,), (3, 50, 11)] for w in (1, 8)]
    cases += [(s, WORKERS) for s in lenet]
    for shape, w in cases:
        (x,), (c,), (d,) = leaf_list(w, [shape])
        kx, kc = elastic.elastic_update(x, c, d, alpha, use_kernel=True)
        torch.cuda.synchronize()
        px, pc = elastic.elastic_update_plain(x, c, d, alpha)
        torch.testing.assert_close(kx, px, rtol=TOL, atol=TOL)
        torch.testing.assert_close(kc, pc, rtol=TOL, atol=TOL)
        max_err = max(max_err, (kx - px).abs().max().item(),
                      (kc - pc).abs().max().item())
    phase("kernels", f"elastic_update: {len(cases)} cases match the plain "
          f"version (rtol=atol={TOL}), max |err| {max_err:.3g}")

    ragged = [(7,), (13,), (3, 50, 11), (65549,), (1,), (1021,)]
    many = [(1 + 97 * i % 2999,) for i in range(elastic.MAX_LEAVES + 9)]
    lists = [("LeNet", WORKERS, lenet, 0), ("LSTM", WORKERS, lstm, 0),
             ("ragged", 1, ragged, 1),
             ("ragged", WORKERS, ragged, 3), ("longer than the cap", WORKERS, many, 0)]
    leaves_err = 0.0
    for name, w, shapes, offset in lists:
        xs, cs, ds = leaf_list(w, shapes, offset)
        before = elastic.launches
        kxs, kcs = elastic.elastic_update_leaves(xs, cs, ds, alpha, use_kernel=True)
        torch.cuda.synchronize()
        launched = elastic.launches - before
        if launched != -(-len(shapes) // elastic.MAX_LEAVES):
            raise AssertionError(f"{name} list of {len(shapes)} leaves: {launched} launches")
        pxs, pcs = elastic.elastic_update_leaves(xs, cs, ds, alpha, use_kernel=False)
        for got, want in zip(kxs + kcs, pxs + pcs):
            torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
            leaves_err = max(leaves_err, (got - want).abs().max().item())
        phase("kernels", f"elastic_update_leaves: {name} list, {len(shapes)} leaves, "
              f"W = {w}, offset {offset}: {launched} launch(es), matches the plain "
              f"version (rtol=atol={TOL})")
    max_err = max(max_err, leaves_err)

    # a round at each path's shapes (LeNet's 8 leaves, the LSTM's 27), W = 8,
    # as one launch and, for comparison in this call, as one launch per leaf
    rows = {name: elastic_round_times(leaf_list(WORKERS, shapes), alpha)
            for name, shapes in (("LeNet", lenet), ("LSTM", lstm))}
    for name, row in rows.items():
        phase("kernels", f"elastic_update_leaves per round ({name}, W = 8; ms by CUDA "
              "events, device_ms by the profiler): " + json.dumps(row))
    row = rows["LeNet"]
    return dict(
        name="elastic_update", route="cuda",
        source="mpit_tpu_torch/ops/csrc/elastic.cu",
        replaces="mpit_tpu/ops/elastic.py:70",
        max_abs_err=max_err, ms=row["ms"], plain_ms=row["plain_ms"],
        bound_ms=row["bound_ms"], bound_by="bytes", library_ms=row["library_ms"],
    )


def flash_bytes_flops(kernel: str, bh: int, t: int, d: int, elt: int,
                      causal: bool) -> tuple[int, float]:
    """Least bytes moved (each input read once, each output written once)
    and the FLOPs of the products this causal/full attention needs; a
    kernel of either family does the same work."""
    kernel = kernel.removesuffix("_sm90")
    tensors = {"flash_forward": 4, "flash_dq": 5, "flash_dkv": 6}[kernel]
    rows = {"flash_forward": 1, "flash_dq": 2, "flash_dkv": 2}[kernel]
    products = {"flash_forward": 2, "flash_dq": 3, "flash_dkv": 4}[kernel]
    pairs = bh * (t * (t + 1) // 2 if causal else t * t)
    return tensors * bh * t * d * elt + rows * bh * t * 4, 2.0 * products * pairs * d


def flash_bound_ms(kernel, bh, t, d, elt, causal) -> tuple[float, str]:
    nbytes, flops = flash_bytes_flops(kernel, bh, t, d, elt, causal)
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return 1e3 * max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def flash_vs_plain() -> dict:
    """Both flash families against their plain versions, then timed at
    the transformer path's shape. Returns a row per kernel."""
    from mpit_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1)
    err = {k: 0.0 for k in fa.launches}

    def qkv(shape, dtype):
        return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
                for _ in range(3)]

    def close(name, got, want, tol):
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
        err[name] = max(err[name], (got.float() - want.float()).abs().max().item())

    def family(q, dispatch=True):
        """The kernels a case should launch: the family the Function's
        rule picks for q, or the CUDA-core kernels called directly."""
        tag = "_sm90" if dispatch and fa._sm90_takes(q) else ""
        return {"flash_forward" + tag: 1, "flash_dq" + tag: 1, "flash_dkv" + tag: 1}

    def against_plain(shape, dtype, causal, dispatch):
        """Each kernel of one case against its plain version, through the
        Function's dispatch or the CUDA-core kernels directly; the
        counters must show the kernels the case should launch."""
        q, k, v = (fa._to2d(x) for x in qkv(shape, dtype))
        do = fa._to2d(qkv(shape, dtype)[0])
        want = family(q, dispatch)
        fwd, dqn, dkv = want
        before = dict(fa.launches)
        if dispatch:
            o, lse = fa._Flash.forward(q, k, v, causal, True)
        else:
            o, lse = fa.flash_forward_cuda(q, k, v, causal)
        torch.cuda.synchronize()
        po, plse = fa.flash_forward_plain(q, k, v, causal)
        close(fwd, o, po, FLASH_TOL[dtype])
        close(fwd, lse, plse, FLASH_TOL[dtype])
        dd = (do.float() * po.float()).sum(-1)
        if dispatch:
            dq, dk, dv = fa._FlashBackward.forward(q, k, v, po, plse, do, causal, True)
        else:
            dq = fa.flash_dq_cuda(q, k, v, do, plse, dd, causal)
            dk, dv = fa.flash_dkv_cuda(q, k, v, do, plse, dd, causal)
        torch.cuda.synchronize()
        pdk, pdv = fa.flash_dkv_plain(q, k, v, do, plse, dd, causal)
        close(dqn, dq, fa.flash_dq_plain(q, k, v, do, plse, dd, causal),
              FLASH_GRAD_TOL[dtype])
        close(dkv, dk, pdk, FLASH_GRAD_TOL[dtype])
        close(dkv, dv, pdv, FLASH_GRAD_TOL[dtype])
        got = {n: c - before[n] for n, c in fa.launches.items() if c != before[n]}
        if got != want:
            raise AssertionError(f"{shape} {dtype} launched {got}, not {want}")

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [((2, 256, 2, 16), f32, True), ((2, 256, 2, 16), f32, False),
             ((2, 256, 2, 16), bf16, True), ((2, 128, 2, 16), f32, True),
             ((2, 128, 2, 16), f32, False), ((1, 64, 3, 8), f32, True),
             ((1, 128, 2, 128), bf16, True), ((1, 96, 2, 40), f32, False),
             (LM_SHAPE, bf16, True)]
    for shape, dtype, causal in cases:
        against_plain(shape, dtype, causal, dispatch=False)
    # bf16 D = 64 with T % 64 == 0 goes to sm90; T = 96 and f32 do not
    sm90_cases = [((2, 256, 2, 64), bf16, True), ((2, 256, 2, 64), bf16, False),
                  ((1, 128, 2, 64), bf16, True), (LM_SHAPE, bf16, True),
                  ((1, 96, 2, 64), bf16, True), ((1, 128, 2, 64), f32, True)]
    for shape, dtype, causal in sm90_cases:
        against_plain(shape, dtype, causal, dispatch=True)
    phase("flash", f"{len(cases)} cases of the CUDA-core kernels, {len(sm90_cases)} "
          f"through the dispatch ({len(sm90_cases) - 2} of them sm90, each launching "
          f"the family the rule names), each kernel against its plain version "
          f"(f32 {FLASH_TOL[f32]}, bf16 forward {FLASH_TOL[bf16]}, bf16 "
          f"gradients {FLASH_GRAD_TOL[bf16]}): max |err| " + json.dumps(err))

    # training through the autograd.Function against dense attention's
    # gradients: the reference's gradient cases (t, blocks, causal, dtype,
    # head dim) and one that the sm90 kernels take.
    # The loss is O against a fixed N(0, 1) cotangent, so the gradients are
    # O(1) and most of their elements lie beyond the tolerance.
    grad_cases = [(128, 128, True, f32, 16), (256, 128, True, f32, 16),
                  (256, 128, False, f32, 16), (128, 32, True, f32, 16),
                  (256, 128, True, bf16, 16), (256, 128, True, bf16, 64)]
    for t, blocks, causal, dtype, d in grad_cases:
        xs = [x.requires_grad_() for x in qkv((2, t, 2, d), dtype)]
        r = torch.randn((2, t, 2, d), generator=gen, device="cuda")
        before = dict(fa.launches)
        out = fa.flash_attention(*xs, causal=causal, block_q=blocks,
                                 block_k=blocks, use_kernel=True)
        g = torch.autograd.grad((out.float() * r).sum(), xs)
        want = family(fa._to2d(xs[0]))
        got = {n: c - before[n] for n, c in fa.launches.items() if c != before[n]}
        if got != want:
            raise AssertionError(f"autograd case {(t, d, dtype)} launched {got}, not {want}")
        want = torch.autograd.grad(
            (fa.dense_attention(*xs, causal=causal).float() * r).sum(), xs)
        tol = FLASH_GRAD_TOL[dtype]
        for a, b in zip(g, want):
            if (b.float().abs() > tol).float().mean().item() <= 0.5:
                raise AssertionError("gradients too small for the tolerance to hold them")
            torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)
    before = dict(fa.launches)
    q, k, v = qkv((2, 100, 2, 16), f32)
    torch.testing.assert_close(fa.flash_attention(q, k, v, causal=True, use_kernel=True),
                               fa.dense_attention(q, k, v, causal=True), rtol=0, atol=0)
    if fa.launches != before:
        raise AssertionError(f"T = 100 launched a kernel: {before} -> {fa.launches}")
    phase("flash", f"autograd through the kernels matches dense attention's "
          f"gradients in {len(grad_cases)} cases (bf16 D = 64 through sm90); "
          f"T = 100 goes to dense with no launch")

    # times at the path's shape: (B*H, T, D) = (96, 512, 64) bf16 causal
    b, t, h, d = LM_SHAPE
    q4, k4, v4 = qkv(LM_SHAPE, bf16)
    q, k, v = (fa._to2d(x) for x in (q4, k4, v4))
    do = fa._to2d(qkv(LM_SHAPE, bf16)[0])
    o, lse = fa.flash_forward_plain(q, k, v, True)
    dd = (do.float() * o.float()).sum(-1)
    # rows no key sees (LSE +inf) get dQ = 0, not NaN
    lse_inf = lse.clone()
    lse_inf[:, 5:9] = float("inf")
    dq = fa.flash_dq_sm90(q, k, v, do, lse_inf, dd, True)
    torch.cuda.synchronize()
    close("flash_dq_sm90", dq, fa.flash_dq_plain(q, k, v, do, lse_inf, dd, True),
          FLASH_GRAD_TOL[bf16])
    if not (torch.isfinite(dq.float()).all() and not dq[:, 5:9].float().any()):
        raise AssertionError("rows with LSE +inf did not give dQ = 0")
    phase("flash", "flash_dq_sm90: rows with LSE +inf give dQ = 0")
    # library yardstick: SDPA on (B, H, T, D), forward, and its backward
    qs, ks, vs = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q4, k4, v4))
    dos = do.reshape(b, h, t, d)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qs, ks, vs, is_causal=True)
    sdpa_out = sdpa()
    sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
        sdpa_out, (qs, ks, vs), dos, retain_graph=True)
    plain_fwd = lambda: fa.flash_forward_plain(q, k, v, True)  # noqa: E731
    plain_dkv = lambda: fa.flash_dkv_plain(q, k, v, do, lse, dd, True)  # noqa: E731
    fns = {
        "flash_forward": (lambda: fa.flash_forward_cuda(q, k, v, True), plain_fwd, sdpa),
        "flash_dq": (lambda: fa.flash_dq_cuda(q, k, v, do, lse, dd, True),
                     lambda: fa.flash_dq_plain(q, k, v, do, lse, dd, True), sdpa_bwd),
        "flash_dkv": (lambda: fa.flash_dkv_cuda(q, k, v, do, lse, dd, True), plain_dkv,
                      sdpa_bwd),
        "flash_forward_sm90": (lambda: fa.flash_forward_sm90(q, k, v, True), plain_fwd,
                               sdpa),
        "flash_dq_sm90": (lambda: fa.flash_dq_sm90(q, k, v, do, lse, dd, True),
                          lambda: fa.flash_dq_plain(q, k, v, do, lse, dd, True), sdpa_bwd),
        "flash_dkv_sm90": (lambda: fa.flash_dkv_sm90(q, k, v, do, lse, dd, True),
                           plain_dkv, sdpa_bwd),
    }
    rows = {}
    replaces = {"flash_forward": "mpit_tpu/ops/flash_attention.py:358",
                "flash_dq": "mpit_tpu/ops/flash_attention.py:272",
                "flash_dkv": "mpit_tpu/ops/flash_attention.py:288"}
    for name, (kern, plain, lib) in fns.items():
        bound, by = flash_bound_ms(name, b * h, t, d, 2, True)
        source = "flash_attention_sm90.cu" if name.endswith("_sm90") else "flash_attention.cu"
        row = dict(name=name, route="cuda", source="mpit_tpu_torch/ops/csrc/" + source,
                   replaces=replaces[name.removesuffix("_sm90")], max_abs_err=err[name],
                   ms=time_ms(kern, reps=10, trials=5),
                   plain_ms=time_ms(plain, reps=5, trials=3),
                   bound_ms=bound, bound_by=by,
                   library_ms=time_ms(lib, reps=10, trials=5),
                   device_ms=device_ms(kern), device_library_ms=device_ms(lib))
        rows[name] = row
        phase("flash", json.dumps(row))
    for name in ("flash_forward", "flash_dq", "flash_dkv"):
        new = rows[name + "_sm90"]
        phase("flash", f"{name}: sm90 device {new['device_ms']:.6f} ms against the "
              f"CUDA-core kernel's {rows[name]['device_ms']:.6f} ms "
              f"({rows[name]['device_ms'] / new['device_ms']:.2f}x), SDPA "
              f"{new['device_library_ms']:.6f} ms, bound {new['bound_ms']:.6f} ms")
    return rows


def round_vs_cpu() -> None:
    """One EASGD round of an f32 LeNet on the card (through the kernel)
    against the same round on the CPU (plain version)."""
    import numpy as np

    from mpit_tpu_torch.comm.topology import Topology
    from mpit_tpu_torch.models import LeNet
    from mpit_tpu_torch.optim import SGD
    from mpit_tpu_torch.parallel import EASGDTrainer
    from mpit_tpu_torch.utils.params import tree_leaves, tree_map

    rng = np.random.default_rng(0)
    tau, b = 2, 4
    x = rng.uniform(0, 1, (tau, WORKERS * b, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, (tau, WORKERS * b)).astype(np.int32)
    params = LeNet(compute_dtype=torch.float32, device="cpu").init(
        torch.Generator().manual_seed(0))
    centers = {}
    for dev in ("cuda", "cpu"):
        trainer = EASGDTrainer(
            LeNet(compute_dtype=torch.float32, device=dev), SGD(0.05, 0.9),
            Topology(WORKERS, torch.device(dev)), tau=tau,
        )
        state = trainer.init_state(params=tree_map(torch.clone, params))
        state, m = trainer.step(state, x, y)
        centers[dev] = [t.cpu() for t in tree_leaves(state.center)]
    err = max((a - b).abs().max().item()
              for a, b in zip(centers["cuda"], centers["cpu"]))
    if not err <= 1e-4:
        raise AssertionError(f"card round differs from CPU round by {err}")
    phase("round", f"f32 LeNet EASGD round, card vs CPU: max |center err| {err:.3g}"
          " (tolerance 1e-4)")


def main_path(kernel_ms_per_round: float) -> dict:
    import mpit_tpu_torch
    from mpit_tpu_torch.ops import elastic
    from mpit_tpu_torch.run import run
    from mpit_tpu_torch.utils.config import TrainConfig

    mpit_tpu_torch.finalize()
    topo = mpit_tpu_torch.init(num_workers=WORKERS)
    cfg = dataclasses.replace(TrainConfig().apply_preset("mnist-easgd"), epochs=1)
    phase("main", f"preset mnist-easgd, 1 epoch, W={topo.num_workers} on "
          f"{topo.device}: lr {cfg.lr}, momentum {cfg.momentum}, tau {cfg.tau}, "
          f"global batch {cfg.global_batch}, train_size {cfg.train_size}")
    warm = run(cfg)  # warm-up: first-call set-up of cuDNN, vmap, allocator
    phase("main", f"warm-up run: {warm['samples_per_sec']:.1f} samples/s")

    elastic.launches = 0
    res = run(cfg)
    launches = elastic.launches

    rounds = res["trained_units"]
    losses = res["round_losses"]
    if launches != rounds:
        raise AssertionError(f"elastic launches {launches} != rounds {rounds}")
    if not all(map(lambda v: v == v and abs(v) != float("inf"), losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    # chance is 0.1; one epoch is early in training, where the accuracy
    # of the center still swings with the init draw (0.55 to 0.94 seen)
    if not res["accuracy"] > 0.3:
        raise AssertionError(f"center accuracy {res['accuracy']} is near chance")
    round_ms = 1e3 * res["wall_s"] / rounds
    phase("main", json.dumps({k: res[k] for k in (
        "accuracy", "final_loss", "round_losses", "trained_units", "samples",
        "wall_s", "samples_per_sec")}))
    phase("main", f"elastic launches {launches} = {rounds} rounds, one each; "
          f"round {round_ms:.3f} ms, of which the elastic kernel "
          f"{kernel_ms_per_round:.4f} ms ({100 * kernel_ms_per_round / round_ms:.3f}%)")
    return dict(launches=launches)


def profile_rounds(rounds: int = 4) -> None:
    """Where a round's time goes: ``torch.profiler`` over a few EASGD rounds
    built as ``run()`` builds them, after two warm-up rounds. Prints the
    card's busy share of the wall time and the kernels that take most."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mpit_tpu_torch.comm.topology import topology
    from mpit_tpu_torch.data import Batches, load_mnist
    from mpit_tpu_torch.run import build_model, build_optimizer, build_trainer
    from mpit_tpu_torch.utils.config import TrainConfig

    cfg = TrainConfig().apply_preset("mnist-easgd")
    topo = topology()
    trainer = build_trainer(cfg, build_model(cfg, topo.device),
                            build_optimizer(cfg), topo)
    state = trainer.init_state(torch.Generator().manual_seed(cfg.seed))
    x, y, _, _ = load_mnist(synthetic_train=cfg.train_size)
    it = Batches(x, y, global_batch=cfg.global_batch).epoch(0)
    xs, ys = zip(*[next(it) for _ in range(cfg.tau)])
    xr, yr = trainer.round_batches(np.stack(xs), np.stack(ys))
    xr, yr = xr.to(topo.device), yr.to(topo.device)
    for _ in range(2):
        state, _ = trainer._round(state, xr, yr)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            state, m = trainer._round(state, xr, yr)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # device-side events only: an operator's own entry repeats its kernels' time
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        phase("profile", "device busy time: not measured (no device events)")
        return
    phase("profile", f"{rounds} rounds under the profiler: wall {wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), "
          f"idle {100 * (1 - busy_ms / wall_ms):.1f}%")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        phase("profile", f"  {e.self_device_time_total / 1e3 / rounds:9.4f} ms/round "
              f"{e.count // rounds:4d} calls/round  {e.key[:90]}")


def ps_parity() -> None:
    """The two EASGD runtimes on the card: a 1-client, 1-server PS run of
    an f32 LeNet against the collective trainer at W = 1, from the same
    init and with the PS client's batch schedule (``default_rng(seed +
    1000)`` over its whole shard). TF32 off and cuDNN's deterministic
    algorithms, so both sides' convolutions round alike."""
    from mpit_tpu_torch.utils.params import tree_leaves

    tau, alpha, steps, bs, seed = 4, 0.5, 24, 32, 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        center, state, stats, launched = _ps_vs_collective(tau, alpha, steps, bs, seed)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    err = 0.0
    for got, want in zip(tree_leaves(center), tree_leaves(state.center)):
        torch.testing.assert_close(got, want, **PS_TOL)
        err = max(err, (got - want).abs().max().item())
    counts = stats["server_counts"][0]
    phase("ps-parity", f"f32 LeNet (init seed {PS_PARITY_SEED}), 1 client + 1 server vs "
          f"the collective trainer at W = 1, both on the card ({steps} steps, tau {tau}, "
          f"batch {bs}, alpha {alpha}): centers agree (rtol {PS_TOL['rtol']}, atol "
          f"{PS_TOL['atol']}), max |err| {err:.3g}; collective side {launched} elastic "
          f"launches in {steps // tau} rounds; server push_easgd {counts['push_easgd']}, "
          f"fetch {counts['fetch']}")


def _ps_vs_collective(tau, alpha, steps, bs, seed):
    """Both runs of ``ps_parity``; checks the elastic launches of each."""
    import numpy as np

    from mpit_tpu_torch.comm.topology import Topology
    from mpit_tpu_torch.data import load_mnist
    from mpit_tpu_torch.models import LeNet
    from mpit_tpu_torch.ops import elastic
    from mpit_tpu_torch.optim import SGD
    from mpit_tpu_torch.parallel import AsyncPSTrainer, EASGDTrainer

    x, y, _, _ = load_mnist(synthetic_train=2048, synthetic_test=512)
    model = LeNet(compute_dtype=torch.float32, device="cuda")
    params = model.init(torch.Generator().manual_seed(PS_PARITY_SEED))
    before = elastic.launches
    center, stats = AsyncPSTrainer(
        model, SGD(0.05, 0.9), num_clients=1, algo="easgd", alpha=alpha, tau=tau,
    ).train(x, y, steps=steps, batch_size=bs, seed=seed, init_params=params)
    if elastic.launches != before:
        raise AssertionError("the PS run launched the elastic kernel")
    col = EASGDTrainer(model, SGD(0.05, 0.9), Topology(1, torch.device("cuda")),
                       tau=tau, alpha=alpha)
    state = col.init_state(params=params)
    rng = np.random.default_rng(seed + 1000)
    for _ in range(steps // tau):
        idx = [rng.integers(0, len(x), bs) for _ in range(tau)]
        state, _ = col.step(state, np.stack([x[i] for i in idx]),
                            np.stack([y[i] for i in idx]))
    torch.cuda.synchronize()
    launched = elastic.launches - before
    if launched != steps // tau:
        raise AssertionError(f"collective side: {launched} elastic launches in "
                             f"{steps // tau} rounds")
    return center, state, stats, launched


LENET_PARAMS = 857_738     # LeNet's flat parameter vector (the PS exchange), 3.43 MB
WIRE_CORPUS = os.path.join("tests", "fixtures", "wire_corpus", "corpus.jsonl")
PS_PROC = os.path.join("mpit_tpu_torch", "examples", "ptest_proc.py")
PS_PROC_TIMEOUT_S = 300


def wire_phase() -> None:
    """The frame codec: the frozen corpus replays through the port's
    decoder with its recorded verdicts, and LeNet's flat vector and its
    bf16 and int8 quantizations round-trip, timed per encode and decode."""
    import numpy as np

    from mpit_tpu_torch.models import LeNet
    from mpit_tpu_torch.quant import quantize
    from mpit_tpu_torch.transport import fuzz, wire
    from mpit_tpu_torch.utils.params import flatten_params

    report = fuzz.replay_corpus(WIRE_CORPUS)
    if report.failures or (report.corpus_clean, report.corpus_mutations) != (40, 360):
        raise AssertionError(f"wire corpus: {report.summary()}: {report.failures[:3]}")
    phase("wire", f"frozen corpus: {report.corpus_clean} clean frames decode to their "
          f"recorded values, {report.corpus_mutations} mutations keep their verdicts "
          f"(numpy {np.__version__})")
    flat, _ = flatten_params(LeNet(device="cpu").init(torch.Generator().manual_seed(0)))
    vec = flat.numpy().astype(np.float32)
    if vec.size != LENET_PARAMS:
        raise AssertionError(f"LeNet has {vec.size} parameters, not {LENET_PARAMS}")
    for name, payload in (("f32", vec), ("bf16", quantize(vec, "bf16")),
                          ("int8", quantize(vec, "int8"))):
        envelope = (7, 3, 1, payload)  # (attempt, epoch, seq, chunk): a push's shape
        reps = 20
        t0 = time.perf_counter()
        for _ in range(reps):
            buffers = wire.encode_frame(1, 3, envelope, version=wire.WIRE_FORMAT_VERSION)
        enc_ms = 1e3 * (time.perf_counter() - t0) / reps
        data = b"".join(bytes(b) for b in buffers)
        # as the socket decodes: the header apart, the body a view of the
        # buffer it was received into
        _, flags, hlen, hcrc = wire.split_preamble(data[:wire.PREAMBLE_SIZE])
        header = data[wire.PREAMBLE_SIZE:wire.PREAMBLE_SIZE + hlen]
        body = memoryview(data)[wire.PREAMBLE_SIZE + hlen:]
        t0 = time.perf_counter()
        for _ in range(reps):
            src, tag, got = wire.decode_frame(flags, hcrc, header, body)
        dec_ms = 1e3 * (time.perf_counter() - t0) / reps
        if (src, tag) != (1, 3) or not fuzz.deep_equal(got, envelope):
            raise AssertionError(f"wire: the {name} frame did not round-trip")
        phase("wire", f"LeNet vector as {name}: frame of {len(data)} bytes round-trips "
              f"bit-equal; encode {enc_ms:.4f} ms (zero-copy buffer list), decode "
              f"{dec_ms:.4f} ms (views into the received body); host CPU")


def native_phase() -> None:
    """Build the port's C++ broker with the host compiler; it must build
    and carry a message, so that ``transport="auto"`` means it here."""
    import numpy as np

    from mpit_tpu_torch import native
    from mpit_tpu_torch.native import build

    cxx = build.compiler()
    if cxx is None:
        raise AssertionError("native: no C++ compiler on this machine")
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True,
                             timeout=60).stdout.splitlines()[0]
    t0 = time.perf_counter()
    path = build.ensure_built(force=True)
    secs = time.perf_counter() - t0
    broker = native.NativeBroker(2)
    try:
        tps = broker.transports()
        tps[0].send(1, 3, np.arange(5.0))
        got = tps[1].recv(0, 3, timeout=5).payload
    finally:
        broker.close()
    if not np.array_equal(got, np.arange(5.0)) or not native.is_available():
        raise AssertionError("native: the broker did not carry a message")
    phase("native", f"tagged_broker.cpp built by {cxx} ({version}) in {secs:.2f} s "
          f"(set-up) into {os.path.relpath(path)}; a message crossed it")



def busy_union_ms(prof) -> tuple[float, float]:
    """(union, sum) in ms of the device events a profile recorded: the
    union counts a moment the card runs work on two streams at once once,
    the sum counts it twice."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    union, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            union += b - max(a, end)
            end = b
    return union / 1e3, sum(b - a for a, b in spans) / 1e3


def ps_path(card_line: str) -> None:
    """The host-async PS path through ``run()`` at the preset's full width:
    a warm-up run, a timed run, and a run under ``torch.profiler`` for the
    card's busy share, all on the preset's ``transport="auto"`` (which must
    resolve to the C++ broker), then one timed run each over ``inproc`` and
    ``socket``; each is held to the server's counts, finite and falling
    losses and the accuracy floor."""
    import math

    from torch.profiler import ProfilerActivity, profile

    from mpit_tpu_torch.ops import elastic
    from mpit_tpu_torch.ops import flash_attention as fa
    from mpit_tpu_torch.run import run
    from mpit_tpu_torch.utils.config import TrainConfig

    cfg = TrainConfig().apply_preset("mnist-ps")
    rounds = cfg.steps // cfg.tau
    want = {"push_easgd": cfg.clients * rounds, "fetch": cfg.clients * (rounds + 1)}
    phase("ps", f"preset mnist-ps: {cfg.model}, {cfg.algo}, {cfg.clients} clients, "
          f"{cfg.servers} server, {cfg.steps} local steps each, tau {cfg.tau}, lr "
          f"{cfg.lr}, momentum {cfg.momentum}, global batch {cfg.global_batch}, alpha "
          f"0.9/clients = {0.9 / cfg.clients}, transport {cfg.transport}, train_size "
          f"{cfg.train_size}")

    def checked_run(what: str, transport: str = cfg.transport) -> dict:
        before = (elastic.launches, dict(fa.launches))
        res = run(dataclasses.replace(cfg, transport=transport))
        torch.cuda.synchronize()
        if (elastic.launches, fa.launches) != before:
            raise AssertionError(f"{what}: the PS path launched a kernel of the port")
        got = {k: res["server_counts"][0][k] for k in want}
        if got != want or res["dead_clients"]:
            raise AssertionError(f"{what}: server counts {got} != {want}, dead "
                                 f"clients {res['dead_clients']}")
        for c, losses in enumerate(res["client_losses"]):
            if len(losses) != cfg.steps or not all(map(math.isfinite, losses)):
                raise AssertionError(f"{what}: client {c}: {len(losses)} losses, "
                                     f"finite {all(map(math.isfinite, losses))}")
            first, last = statistics.mean(losses[:8]), statistics.mean(losses[-8:])
            if not last < first:
                raise AssertionError(f"{what}: client {c}: loss did not fall: first "
                                     f"8 steps {first}, last 8 {last}")
        if not res["accuracy"] > 0.3:
            raise AssertionError(f"{what}: center accuracy {res['accuracy']} is near "
                                 "chance")
        return res

    warm = checked_run("warm-up run")  # first-call set-up: cuDNN, streams, allocator
    if warm["transport_used"] != "native":
        raise AssertionError(f"transport auto used {warm['transport_used']}, not the "
                             "C++ broker")
    phase("ps", f"warm-up run: {warm['samples_per_sec']:.1f} samples/s; transport "
          f"{cfg.transport} used the {warm['transport_used']} broker")
    res = checked_run("timed run")
    for c, losses in enumerate(res["client_losses"]):
        phase("ps", f"client {c}: loss first 8 steps {statistics.mean(losses[:8]):.4f}, "
              f"last 8 {statistics.mean(losses[-8:]):.4f}")
    phase("ps", json.dumps({k: res[k] for k in (
        "accuracy", "final_loss", "server_counts", "dead_clients", "samples",
        "wall_s", "samples_per_sec", "exchange_ms_per_round")}))
    phase("ps", f"timed run: server push_easgd {want['push_easgd']}, fetch "
          f"{want['fetch']} (= {cfg.clients} x {rounds} rounds, + 1 initial fetch "
          f"each); no kernel of the port launched; {res['samples_per_sec']:.1f} "
          f"samples/s, wall {res['wall_s']:.3f} s, exchange ms per round by client "
          f"{[round(v, 3) for v in res['exchange_ms_per_round']]}; {card_line}")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prof_res = checked_run("profiled run")
        window_ms = 1e3 * (time.perf_counter() - t0)
    union_ms, sum_ms = busy_union_ms(prof)
    busy = ("not measured (no device events)" if union_ms == 0 else
            f"{100 * union_ms / window_ms:.2f}% ({union_ms:.3f} ms of device events, "
            f"overlaps counted once; {sum_ms:.3f} ms summed, of {window_ms:.3f} ms)")
    phase("ps", f"device busy share of a run under torch.profiler: {busy}; that run "
          f"{prof_res['samples_per_sec']:.1f} samples/s; {card_line}")
    for transport in ("inproc", "socket"):
        r = checked_run(f"{transport} run", transport)
        counts = {k: r["server_counts"][0][k] for k in want}
        phase("ps", f"transport {transport}: {r['samples_per_sec']:.1f} samples/s, wall "
              f"{r['wall_s']:.3f} s, exchange ms per round by client "
              f"{[round(v, 3) for v in r['exchange_ms_per_round']]}, server {counts}, "
              f"accuracy {r['accuracy']}; {card_line}")


# the reference's acceptance schedule for chaos (tests/test_chaos.py:337-344):
# drops only on the retryable FETCH/PARAM path, duplicates and resets also
# on the pushes, so "applied exactly once" is checkable as counts == sends
def chaos_config(seed: int):
    from mpit_tpu_torch.parallel.pserver import TAG_FETCH, TAG_PARAM, TAG_PUSH_EASGD
    from mpit_tpu_torch.transport import ChaosConfig

    return ChaosConfig(
        seed=seed, drop=0.06, drop_tags=(TAG_FETCH, TAG_PARAM), duplicate=0.12,
        reset=0.08, reset_tags=(TAG_FETCH, TAG_PUSH_EASGD),
        tags=(TAG_FETCH, TAG_PARAM, TAG_PUSH_EASGD),
    )


PS_CHAOS_SEED = 1234
PS_CHAOS_STEPS = 48


def ps_chaos(card_line: str) -> None:
    """Thread mode over real sockets under the seeded chaos schedule, at the
    preset's width (bf16 LeNet on the card, 2 clients, τ = 4, batch 128):
    every push the clients sent is applied exactly once, each fault kind
    fires, and a second run with the same seed logs the same faults."""
    import math

    from mpit_tpu_torch.data import load_mnist
    from mpit_tpu_torch.models import LeNet
    from mpit_tpu_torch.optim import SGD
    from mpit_tpu_torch.parallel import AsyncPSTrainer

    x, y, _, _ = load_mnist(synthetic_train=8192, synthetic_test=512)

    def one_run():
        trainer = AsyncPSTrainer(
            LeNet(device="cuda"), SGD(0.05, 0.9), num_clients=2, num_servers=1,
            alpha=0.45, tau=4, transport="socket", chaos=chaos_config(PS_CHAOS_SEED),
            max_exchange_failures=5, fetch_timeout=1.0, fetch_retries=3, device="cuda",
        )
        t0 = time.perf_counter()
        _, stats = trainer.train(x, y, steps=PS_CHAOS_STEPS, batch_size=128)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = stats["server_counts"][0]
        sent = sum(c.get(0, 0) for c in stats["push_sent"])
        if counts["push_easgd"] != sent:
            raise AssertionError(f"ps-chaos: applied {counts['push_easgd']} pushes, "
                                 f"sent {sent}")
        if not all(math.isfinite(v) for l in stats["losses"] for v in l):
            raise AssertionError("ps-chaos: a loss is not finite")
        return trainer.fault_log.events(), stats, wall

    events, stats, wall = one_run()
    faults = stats["chaos_faults"]
    if not all(faults.get(k, 0) > 0 for k in ("drop", "duplicate", "reset")):
        raise AssertionError(f"ps-chaos: a fault kind never fired: {faults}")
    events2, stats2, wall2 = one_run()
    if events2 != events:
        raise AssertionError("ps-chaos: the same seed gave another fault log")
    counts = stats["server_counts"][0]
    phase("ps-chaos", f"socket transport, seed {PS_CHAOS_SEED}, {PS_CHAOS_STEPS} steps "
          f"per client: faults {faults}; push_easgd {counts['push_easgd']} = pushes sent, "
          f"dup_dropped {counts['dup_dropped']}, skipped rounds {stats['skipped_rounds']}; "
          f"a second run logged the same {len(events)} faults; walls {wall:.3f} and "
          f"{wall2:.3f} s; {card_line}")


def _launch(n: int, args: list, env: dict) -> tuple[str, float]:
    """``python -m mpit_tpu_torch.launch -n n ptest_proc.py args``; returns
    its output and wall seconds; fails on a non-zero exit."""
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "mpit_tpu_torch.launch", "-n", str(n), PS_PROC, *args],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env, capture_output=True,
        text=True, timeout=PS_PROC_TIMEOUT_S,
    )
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"launcher exited {r.returncode}:\n{r.stdout[-4000:]}\n"
                             f"{r.stderr[-4000:]}")
    return r.stdout, wall


def ps_proc_loops(out: str, clients: int, what: str) -> list:
    """Each pclient's (index, samples, loop seconds, samples/s, exchange ms
    per round) from a process-mode run's output."""
    loops = re.findall(r"pclient (\d+): trained (\d+) samples in ([0-9.]+) s of its "
                       r"training loop, ([0-9.]+) samples/s on cuda; exchange ([0-9.]+) "
                       r"ms per round", out)
    if len(loops) != clients:
        raise AssertionError(f"{what}: {len(loops)} client timing lines:\n{out[-3000:]}")
    return loops


def ps_proc(card_line: str) -> dict:
    """Process mode: the launcher runs ``--preset mnist-ps`` as three OS
    processes over sockets, the pserver without a CUDA context and each
    pclient on the card; then an elastic leg whose server snapshot must
    load and hold the center its client last fetched. Returns each
    client's samples/s (obs off), which the obs-ps phase compares with."""
    import hashlib
    import tempfile

    from mpit_tpu_torch.utils.checkpoint import load_shard_state
    from mpit_tpu_torch.utils.config import TrainConfig

    cfg = TrainConfig().apply_preset("mnist-ps")
    rounds = cfg.steps // cfg.tau
    # every client pushes once a round and fetches once a round plus its
    # first fetch; client 0 fetches once more to evaluate the center
    # (examples/ptest_proc.py:211)
    want = (f"'fetch': {cfg.clients * (rounds + 1) + 1}, 'push_easgd': "
            f"{cfg.clients * rounds}")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MPIT_", "CUDA_VISIBLE"))}
    env["CUDA_VISIBLE_DEVICES"] = os.environ["CUDA_VISIBLE_DEVICES"]
    out, wall = _launch(cfg.servers + cfg.clients, ["--preset", "mnist-ps"], env)
    server = [l for l in out.splitlines() if "pserver rank 0: counts=" in l]
    if len(server) != 1 or want not in server[0] or "dead_clients=[]" not in server[0]:
        raise AssertionError(f"ps-proc: server line {server} lacks {want} or "
                             f"dead_clients=[]:\n{out[-3000:]}")
    if "pserver rank 0: cuda initialized=False" not in out:
        raise AssertionError(f"ps-proc: the server created a CUDA context:\n{out[-3000:]}")
    acc = re.search(r"pclient 0: test acc=([0-9.]+)", out)
    if acc is None or not float(acc.group(1)) > 0.3:
        raise AssertionError(f"ps-proc: client 0's accuracy is missing or near chance:"
                             f"\n{out[-3000:]}")
    loops = ps_proc_loops(out, cfg.clients, "ps-proc")
    samples = sum(int(n) for _, n, _, _, _ in loops)
    slowest = max(float(t) for _, _, t, _, _ in loops)
    phase("ps-proc", f"python -m mpit_tpu_torch.launch -n 3 {PS_PROC} --preset "
          f"mnist-ps: exit 0 in {wall:.3f} s of launcher wall (process start, data and "
          f"CUDA set-up included); server {want}, dead_clients=[], no CUDA context on "
          f"the server; client 0 test acc {acc.group(1)}")
    phase("ps-proc", "per client: " + "; ".join(
        f"pclient {c}: {n} samples in {t} s, {r} samples/s, exchange {x} ms per round"
        for c, n, t, r, x in loops)
        + f"; together {samples / slowest:.1f} samples/s over the slower loop; "
        + card_line)
    with tempfile.TemporaryDirectory(prefix="ps-proc-elastic-") as ckpt:
        env2 = dict(env, MPIT_ELASTIC_RESPAWN="1", MPIT_ELASTIC_CKPT_DIR=ckpt)
        out2, wall2 = _launch(2, ["--preset", "mnist-ps", "--steps", "40"], env2)
        digest = re.search(r"pclient 0: fetched center sha256=([0-9a-f]+)", out2)
        state = load_shard_state(os.path.join(ckpt, "shard_0.msgpack"))
        center = state["center"]
        got = hashlib.sha256(center.tobytes()).hexdigest()
        if digest is None or got != digest.group(1):
            raise AssertionError(f"ps-proc: the snapshot's center ({got}) is not the one "
                                 f"the client last fetched:\n{out2[-3000:]}")
    phase("ps-proc", f"elastic leg (1 server, 1 client, 40 steps, MPIT_ELASTIC_RESPAWN=1, "
          f"MPIT_ELASTIC_CKPT_DIR): exit 0 in {wall2:.3f} s; shard_0.msgpack loads with "
          f"load_shard_state ({center.size} floats, version {state['version']}, gen "
          f"{state['gen']}) and holds the center the client last fetched (sha256 equal)")
    return {int(c): float(r) for c, _, _, r, _ in loops}


OBS_TAGS = {1: "FETCH", 2: "PUSH_EASGD", 4: "PARAM", 5: "STOP"}


def obs_cli(*args, process: bool = False) -> tuple[int, str]:
    """``python -m mpit_tpu_torch.obs *args``: its exit code and output;
    its ``main`` in this process unless ``process`` (a process of its own
    costs seconds of interpreter and torch start)."""
    if process:
        r = subprocess.run([sys.executable, "-m", "mpit_tpu_torch.obs", *args],
                           cwd=os.path.dirname(os.path.abspath(__file__)),
                           capture_output=True, text=True, timeout=120)
        rc, out, err = r.returncode, r.stdout, r.stderr
    else:
        import contextlib
        import io

        from mpit_tpu_torch.obs.__main__ import main as obs_main

        buf, ebuf = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(ebuf):
            rc = obs_main(list(args))
        out, err = buf.getvalue(), ebuf.getvalue()
    if rc not in (0, 1):
        raise AssertionError(f"obs {' '.join(args)} exited {rc}:\n{out[-2000:]}\n"
                             f"{err[-2000:]}")
    return rc, out


def obs_ps(card_line: str, off: dict) -> None:
    """Path 1 of the obs plane: the ps-proc run (``--preset mnist-ps``, three
    OS processes, full-width LeNet) again with ``MPIT_OBS_DIR``,
    ``MPIT_OBS_LIVE=1`` and the black box armed; every rank's journal,
    black-box dump and live snapshot are there, the port's CLI reads the
    directory (``merge``, ``summary``, ``roofline``, ``dynamics``, ``live``,
    and ``postmortem`` after a ``request_dump``), each rank's telemetry
    gives the exchange's phase split per stream, and the samples/s with obs
    on stand beside the ps-proc phase's with obs off."""
    import tempfile

    from mpit_tpu_torch.obs.blackbox import request_dump
    from mpit_tpu_torch.utils.config import TrainConfig

    cfg = TrainConfig().apply_preset("mnist-ps")
    rounds = cfg.steps // cfg.tau
    n = cfg.servers + cfg.clients
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MPIT_", "CUDA_VISIBLE"))}
    env["CUDA_VISIBLE_DEVICES"] = os.environ["CUDA_VISIBLE_DEVICES"]
    with tempfile.TemporaryDirectory(prefix="obs-ps-") as obs:
        env.update(MPIT_OBS_DIR=obs, MPIT_OBS_LIVE="1")
        out, wall = _launch(n, ["--preset", "mnist-ps"], env)
        want = (f"'fetch': {cfg.clients * (rounds + 1) + 1}, 'push_easgd': "
                f"{cfg.clients * rounds}")
        if want not in out or "dead_clients=[]" not in out:
            raise AssertionError(f"obs-ps: server counts lack {want}:\n{out[-3000:]}")
        loops = ps_proc_loops(out, cfg.clients, "obs-ps")
        tel = {}
        for line in out.splitlines():
            m = re.search(r"rank (\d+): telemetry (\{.*\})$", line)
            if m:
                tel[int(m.group(1))] = json.loads(m.group(2))
        files = sorted(os.listdir(obs))
        boxes = sorted(os.listdir(os.path.join(obs, "blackbox")))
        snaps = sorted(os.listdir(os.path.join(obs, "live")))
        if (sorted(tel) != list(range(n))
                or [f for f in files if f.startswith("obs_rank")]
                != [f"obs_rank{r}.jsonl" for r in range(n)]
                or boxes != [f"rank_{r}.jsonl" for r in range(n)]
                or snaps != [f"rank_{r}.json" for r in range(n)]):
            raise AssertionError(f"obs-ps: telemetry of ranks {sorted(tel)}, files {files}, "
                                 f"black box {boxes}, live {snaps}")
        rc, merged = obs_cli("merge", obs, "-o", os.path.join(obs, "trace.json"))
        with open(os.path.join(obs, "trace.json")) as f:
            events = len(json.load(f)["traceEvents"])
        rc_sum, summ = obs_cli("summary", obs, process=True)
        rc_roof, roof = obs_cli("roofline", obs, "--json")
        roof = json.loads(roof)
        rc_dyn, dyn = obs_cli("dynamics", obs, "--json")
        dyn = json.loads(dyn)
        rc_val, val = obs_cli("live", obs, "--validate")
        rc_live, live = obs_cli("live", obs, "--once", "--json", "--no-dump")
        live = json.loads(live)
        incident = request_dump(obs, "chip-smoke")
        rc_pm, pm = obs_cli("postmortem", obs, "--json")
        pm = json.loads(pm)
    if (rc or rc_sum or rc_roof or rc_dyn or rc_val or "0 invalid" not in val
            or len(summ.splitlines()) != n
            or sorted(dyn["clients"]) != [str(c) for c in range(1, n)]
            or any(c["rounds"] != rounds for c in dyn["clients"].values())
            or sorted(pm["ranks"]) != [str(r) for r in range(n)]):
        raise AssertionError(f"obs-ps: the CLI on the run: merge {rc}, summary {rc_sum} "
                             f"{summ!r}, roofline {rc_roof}, dynamics {rc_dyn} {dyn}, live "
                             f"{rc_val} {val!r}, postmortem {pm.get('ranks')}")
    for r, v in roof["ranks"].items():
        if abs(sum(v["phases"].values()) - 1.0) > 1e-6:
            raise AssertionError(f"obs-ps: rank {r}'s roofline phases {v['phases']}")
    phase("obs-ps", f"launch -n {n} {PS_PROC} --preset mnist-ps with MPIT_OBS_DIR, "
          f"MPIT_OBS_LIVE=1, black box on: exit 0 in {wall:.3f} s; {n} journals, black-box "
          f"dumps and live snapshots; merge: {events} trace events; "
          + "; ".join(summ.splitlines()))
    phase("obs-ps", "roofline by rank: " + "; ".join(
        f"rank {r} ({v['role']}) window {v['window_s']:.3f} s: compute "
        f"{v['phases']['compute']:.4f}, wire {v['phases']['wire']:.4f}, idle "
        f"{v['phases']['idle']:.4f}, overhead {v['phases']['overhead']:.4f}"
        for r, v in sorted(roof["ranks"].items())))
    phase("obs-ps", "dynamics: " + "; ".join(
        f"client {c}: {v['rounds']} rounds, elastic {v['elastic']['first']:.4f} -> "
        f"{v['elastic']['final']:.4f}" for c, v in sorted(dyn["clients"].items()))
        + f"; staleness p99 {dyn['run']['staleness_p99']}; live: exit {rc_live}, "
        f"{len(live.get('alerts_fired', []))} alert(s) "
        f"{[a['kind'] for a in live.get('alerts_fired', [])]}; postmortem after "
        f"request_dump({incident!r}): exit {rc_pm}, verdict {pm['verdict']}")
    # the exchange's split, per stream and message: what the sender's
    # socket spent (serialize, queue_wait, write) and the receiver's
    # (transfer, deserialize)
    for r in range(n):
        parts = []
        for key, v in sorted(tel[r]["send"].items()):
            dst, tag = key.split(":")
            ph = v.get("phase_s", {})
            parts.append(f"send {OBS_TAGS.get(int(tag), tag)} to {dst} x{v['msgs']}: " + ", ".join(
                f"{k} {1e3 * t / v['msgs']:.4f}" for k, t in sorted(ph.items())) + " ms/msg")
        for key, v in sorted(tel[r].get("rx_phase_s", {}).items()):
            src, tag = key.split(":")
            parts.append(f"recv {OBS_TAGS.get(int(tag), tag)} from {src} x{v['msgs']}: "
                         f"transfer {1e3 * v['transfer'] / v['msgs']:.4f}, deserialize "
                         f"{1e3 * v['deserialize'] / v['msgs']:.4f} ms/msg")
        phase("obs-ps", f"rank {r} rx_phase_s/phase_s split: " + "; ".join(parts))
    phase("obs-ps", "samples/s obs off (ps-proc) -> on: " + "; ".join(
        f"pclient {c}: {off[int(c)]:.1f} -> {float(rate):.1f} "
        f"({100 * (float(rate) / off[int(c)] - 1):+.1f}%), exchange {x} ms per round"
        for c, _, _, rate, x in loops) + f"; {card_line}")


RT_SCRIPT = '''
import dataclasses, json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
from mpit_tpu_torch import quant
from mpit_tpu_torch.analysis import runtime as rt
from mpit_tpu_torch.run import run
from mpit_tpu_torch.utils.config import TrainConfig

ck = rt.active_checker()
cfg = dataclasses.replace(TrainConfig().apply_preset("mnist-ps"), steps=int(sys.argv[2]))
res = run(cfg)
out = {"transport": res["transport_used"], "counts": res["server_counts"][0],
       "samples_per_sec": res["samples_per_sec"], "armed": ck is not None}
if ck is not None:
    out["clean"] = [f.format() for f in ck.findings]
    poisoned = np.ones((4, 64), np.float32)
    poisoned[1, 7] = np.nan
    quant.quantize_rows(poisoned, "int8")
    out["after"] = [f.rule for f in ck.findings]
print(json.dumps(out))
'''
RT_STEPS = 40


def _rt_run(armed: bool) -> tuple[dict, str, float]:
    """RT_SCRIPT in a process of its own, with the sanitizers' knobs set
    or not: its result, its standard error and its wall seconds."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("MPIT_")}
    if armed:
        env.update(MPIT_RT_RACE="1", MPIT_RT_NUMERICS="1")
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", RT_SCRIPT, here, str(RT_STEPS)], cwd=here,
                       env=env, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"rt: exited {r.returncode}:\n{r.stdout[-3000:]}\n"
                             f"{r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1]), r.stderr, wall


def rt_path(card_line: str) -> None:
    """Path 3 of the obs plane: the sanitizers. A short ``mnist-ps`` in
    threads on the card (``transport="auto"``, 40 local steps a client) in a
    process started with ``MPIT_RT_RACE=1 MPIT_RT_NUMERICS=1``, which arm
    RT101-RT104 at import: no finding; then one NaN planted into the numpy
    quant face is exactly one RT104, and the exit report counts it. The
    same run without the knobs, before it, gives what the checkers cost."""
    plain, _, plain_wall = _rt_run(armed=False)
    got, err, wall = _rt_run(armed=True)
    rounds = RT_STEPS // 4
    if (plain["armed"] or not got["armed"] or got["clean"] or got["after"] != ["RT104"]
            or {got["counts"]["push_easgd"], plain["counts"]["push_easgd"]} != {2 * rounds}
            or "[rt-race] 0 finding(s)" not in err
            or "[rt-numerics] 1 finding(s)" not in err):
        raise AssertionError(f"rt: unarmed {plain}, armed {got}\n{err[-3000:]}")
    phase("rt", f"mnist-ps in threads ({got['transport']}, {RT_STEPS} steps a client) under "
          f"MPIT_RT_RACE=1 MPIT_RT_NUMERICS=1: 0 findings, push_easgd "
          f"{got['counts']['push_easgd']}; one NaN into quant.quantize_rows: findings "
          f"{got['after']}; exit report '[rt-race] 0 finding(s)', '[rt-numerics] 1 "
          f"finding(s)'. samples/s unarmed {plain['samples_per_sec']:.1f}, armed "
          f"{got['samples_per_sec']:.1f} ({got['samples_per_sec'] / plain['samples_per_sec']:.3f}"
          f"x); process wall {plain_wall:.3f} and {wall:.3f} s; {card_line}")


def step_vs_cpu() -> dict:
    """One sync-DP step of an f32 2-layer flash transformer on the card
    (through the kernels) against the same step on the CPU (plain
    versions), from the same params and batch. Returns the card step's
    launches per flash kernel."""
    import numpy as np

    from mpit_tpu_torch.comm.topology import Topology
    from mpit_tpu_torch.models import TransformerLM
    from mpit_tpu_torch.optim import SGD
    from mpit_tpu_torch.ops import flash_attention as fa
    from mpit_tpu_torch.parallel import DataParallelTrainer
    from mpit_tpu_torch.utils.params import tree_leaves, tree_map

    rng = np.random.default_rng(0)
    x = rng.integers(0, 97, (WORKERS, 128)).astype(np.int32)
    y = rng.integers(0, 97, (WORKERS, 128)).astype(np.int32)
    make = lambda dev: TransformerLM(  # noqa: E731
        97, num_layers=2, d_model=64, num_heads=4, max_len=128,
        compute_dtype=torch.float32, attn_impl="flash", device=dev)
    params = make("cpu").init(torch.Generator().manual_seed(0))
    out, losses, launches = {}, {}, {}
    for dev in ("cuda", "cpu"):
        trainer = DataParallelTrainer(make(dev), SGD(0.1),
                                      Topology(WORKERS, torch.device(dev)))
        state = trainer.init_state(params=tree_map(torch.clone, params))
        for k in fa.launches:
            fa.launches[k] = 0
        state, m = trainer.step(state, x, y)
        launches[dev] = dict(fa.launches)
        out[dev] = [t.cpu() for t in tree_leaves(state.params)]
        losses[dev] = float(m["loss"])
    got = launches["cuda"]
    want = {"flash_forward": 2, "flash_dq": 2, "flash_dkv": 2,
            "flash_forward_sm90": 0, "flash_dq_sm90": 0, "flash_dkv_sm90": 0}
    if got != want or any(launches["cpu"].values()):
        raise AssertionError(f"f32 step launched {launches}, not {want} on the card "
                             "and nothing on the CPU")
    err = max((a - b).abs().max().item() for a, b in zip(out["cuda"], out["cpu"]))
    if not err <= 1e-4 or abs(losses["cuda"] - losses["cpu"]) > 1e-4:
        raise AssertionError(f"card step differs from CPU step: params {err}, "
                             f"losses {losses}")
    phase("step", f"f32 2-layer flash transformer, one sync step, card vs CPU: "
          f"max |param err| {err:.3g}, loss {losses['cuda']:.6f} vs "
          f"{losses['cpu']:.6f} (tolerance 1e-4); flash launches {json.dumps(got)}")
    return got


def lm_config():
    from mpit_tpu_torch.utils.config import TrainConfig

    return dataclasses.replace(
        TrainConfig().apply_preset("ptb-transformer-large"),
        algo="sync", attn_impl="flash", epochs=1, train_size=LM_TRAIN_WINDOWS,
    )


def lm_eval_chunks(cfg) -> int:
    """The eval forwards of a run: the reference's eval batches, 64
    windows at a time."""
    from mpit_tpu_torch.run import _ptb_windows

    x_va = _ptb_windows(cfg)[2]
    batch = (min(1024, len(x_va)) // WORKERS) * WORKERS
    return (len(x_va) // batch) * -(-batch // 64)


def lm_launches(steps: int, eval_chunks: int) -> dict:
    """The flash launches of a bf16 LM run: the sm90 family only."""
    return {"flash_forward": 0, "flash_dq": 0, "flash_dkv": 0,
            "flash_forward_sm90": LM_LAYERS * (steps + eval_chunks),
            "flash_dq_sm90": LM_LAYERS * steps, "flash_dkv_sm90": LM_LAYERS * steps}


OBS_LM_STEPS = 16


def obs_lm(card_line: str) -> dict:
    """Path 2 of the obs plane: ``ptb-transformer-large --algo sync`` at
    full width under ``MPIT_DP_QUANT=int8``, 16 steps untraced, the same 16
    with ``MPIT_OBS_DIR``, and untraced again:
    the bucketed step journals its ``compute`` spans, one ``send`` per hop
    and a ``dynamics`` record a step; ``roofline --json`` splits the window
    into compute and wire (fractions summing to 1), ``dynamics --json``
    reads every step, and the sm90 flash kernels run (counts set to 0 just
    before). Returns the flash launches."""
    import tempfile

    from mpit_tpu_torch.ops import flash_attention as fa
    from mpit_tpu_torch.run import run

    cfg = dataclasses.replace(lm_config(), train_size=OBS_LM_STEPS * 8)
    with tempfile.TemporaryDirectory(prefix="obs-lm-") as obs:
        os.environ["MPIT_DP_QUANT"] = "int8"
        try:
            run(cfg)  # warm-up: the int8 bucketed step's first run
            plain = run(cfg)  # the same run untraced: what tracing costs
            os.environ["MPIT_OBS_DIR"] = obs
            for k in fa.launches:
                fa.launches[k] = 0
            res = run(cfg)
            launches = dict(fa.launches)
            del os.environ["MPIT_OBS_DIR"]
            plain2 = run(cfg)  # untraced again: plain, traced, plain
        finally:
            os.environ.pop("MPIT_OBS_DIR", None)
            del os.environ["MPIT_DP_QUANT"]
        with open(os.path.join(obs, "obs_rank0.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        rc_roof, roof = obs_cli("roofline", obs, "--json")
        rc_dyn, dyn = obs_cli("dynamics", obs, "--json")
    roof, dyn = json.loads(roof), json.loads(dyn)
    steps = res["trained_units"]
    want = lm_launches(steps, lm_eval_chunks(cfg))
    sends = [r for r in recs if r["ev"] == "send"]
    computes = sum(1 for r in recs if r["ev"] == "span_b" and r["name"] == "compute")
    dynamics = [r for r in recs if r["ev"] == "dynamics"]
    buckets = len(sends) // (2 * steps)
    run_phases = roof["run"]["phases"]
    if (launches != want or rc_roof or rc_dyn or len(dynamics) != steps
            or len(sends) != 2 * buckets * steps or computes != (2 + 2 * buckets) * steps
            or abs(sum(run_phases.values()) - 1.0) > 1e-6
            or dyn["clients"]["0"]["rounds"] != steps
            or not all(r["elastic"] > 0 for r in dynamics)):
        raise AssertionError(f"obs-lm: launches {launches} (want {want}), roofline "
                             f"{rc_roof} {run_phases}, dynamics {rc_dyn} {len(dynamics)} "
                             f"records, {len(sends)} sends, {computes} compute spans")
    wire_bytes = sum(r["bytes"] for r in sends) // steps
    d = dyn["clients"]["0"]
    phase("obs-lm", f"ptb-transformer-large --algo sync, MPIT_DP_QUANT=int8, full width, "
          f"{steps} steps, in turns: untraced {1e3 * plain['wall_s'] / steps:.3f} ms a step "
          f"({plain['samples_per_sec'] * cfg.seq_len:.1f} tokens/s), traced with "
          f"MPIT_OBS_DIR {1e3 * res['wall_s'] / steps:.3f} ms a step "
          f"({res['samples_per_sec'] * cfg.seq_len:.1f} tokens/s), untraced "
          f"{1e3 * plain2['wall_s'] / steps:.3f} ms a step; {buckets} buckets, {len(sends)} send records ({wire_bytes} hop bytes a "
          f"step), {computes} compute spans, {len(dynamics)} dynamics records; flash "
          f"launches {json.dumps(launches)}")
    phase("obs-lm", f"roofline --json: window {roof['run']['window_s']:.3f} s, compute "
          f"{run_phases['compute']:.6f}, wire {run_phases['wire']:.6f}, idle "
          f"{run_phases['idle']:.6f}, overhead {run_phases['overhead']:.6f} (sum "
          f"{sum(run_phases.values()):.9f}); compute {roof['run']['compute_s']:.3f} s, wire "
          f"{roof['run']['wire_s']:.3f} s")
    phase("obs-lm", f"dynamics --json: {d['rounds']} steps, elastic (EF residual norm) "
          f"{d['elastic']['first']:.4f} -> {d['elastic']['final']:.4f}, push_norm "
          f"{d['push_norm']:.5f}, param_norm {d['param_norm']:.3f}, diverging "
          f"{d['diverging']}; {card_line}")
    return launches


def lm_path(flash: dict) -> tuple[dict, list]:
    """The transformer main path through ``run()``; returns the launches
    per flash kernel and the run's losses."""
    from mpit_tpu_torch.ops import flash_attention as fa
    from mpit_tpu_torch.run import run

    cfg = lm_config()
    phase("lm", f"preset ptb-transformer-large, algo sync, attn flash: layers "
          f"{cfg.layers}, d_model {cfg.d_model}, heads {cfg.heads}, T {cfg.seq_len}, "
          f"global batch {cfg.global_batch}, {cfg.optimizer} lr {cfg.lr} "
          f"{cfg.lr_schedule}, train_size {cfg.train_size} windows")
    warm = run(dataclasses.replace(cfg, train_size=16 * cfg.global_batch))
    phase("lm", f"warm-up run: {warm['samples_per_sec']:.2f} samples/s")

    for k in fa.launches:
        fa.launches[k] = 0
    res = run(cfg)
    launches = dict(fa.launches)

    steps = res["trained_units"]
    losses = res["round_losses"]
    eval_chunks = lm_eval_chunks(cfg)
    want = lm_launches(steps, eval_chunks)
    if launches != want:
        raise AssertionError(f"flash launches {launches} != {want} "
                             f"({steps} steps, {eval_chunks} eval forwards)")
    if not all(v == v and abs(v) != float("inf") for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    first, last = statistics.mean(losses[:8]), statistics.mean(losses[-8:])
    if not last < first:
        raise AssertionError(f"loss did not fall: first 8 steps {first}, last 8 {last}")
    step_ms = 1e3 * res["wall_s"] / steps
    attn_ms = LM_LAYERS * sum(flash[k]["ms"] for k in flash if launches[k])
    phase("lm", json.dumps({k: res[k] for k in (
        "accuracy", "eval_loss", "final_loss", "trained_units", "samples",
        "wall_s", "samples_per_sec")}))
    phase("lm", f"losses: first 8 steps {first:.4f}, last 8 {last:.4f}; "
          f"{res['samples_per_sec'] * cfg.seq_len:.1f} tokens/s")
    phase("lm", f"flash launches {json.dumps(launches)} = {steps} steps x "
          f"{LM_LAYERS} layers (+ {LM_LAYERS} x {eval_chunks} eval forwards); "
          f"step {step_ms:.3f} ms, of which the flash kernels (CUDA-event "
          f"times x {LM_LAYERS}) {attn_ms:.3f} ms ({100 * attn_ms / step_ms:.1f}%)")
    return launches, losses


def sync_step(trainer):
    """A sync trainer's step on device tensors: the bucketed exchange's
    when a knob engaged it, else the fused one."""
    return trainer._bucketed_step if getattr(trainer, "bucketed", False) else trainer._step


def built_step(cfg):
    """(trainer, state, x, y): ``cfg``'s trainer and state built as ``run()``
    builds them, and one global batch of its data on the card, laid out as
    the trainer's step takes it."""
    from mpit_tpu_torch.comm.topology import topology
    from mpit_tpu_torch.run import (
        _load_dataset, _world_for, build_model, build_optimizer, build_trainer,
    )

    topo = _world_for(cfg, topology())
    gb = cfg.global_batch
    x_tr, y_tr, _, _, meta = _load_dataset(dataclasses.replace(cfg, train_size=gb))
    trainer = build_trainer(cfg, build_model(cfg, topo.device, meta),
                            build_optimizer(cfg, 64), topo)
    state = trainer.init_state(torch.Generator().manual_seed(cfg.seed))
    x, y = trainer._shard(x_tr[:gb], y_tr[:gb])
    return trainer, state, *(torch.as_tensor(a).to(topo.device) for a in (x, y))


def profile_lm(steps: int = 3, cfg=None, name: str = "lm-profile") -> None:
    """Where a transformer step's time goes: ``torch.profiler`` over a few
    steps of ``cfg`` (default the ``lm`` phase's sync flash LM) built as
    ``run()`` builds them, after two warm-up steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    trainer, state, x, y = built_step(cfg or lm_config())
    for _ in range(2):
        state, _ = trainer._step(state, x, y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, m = trainer._step(state, x, y)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        phase(name, "device busy time: not measured (no device events)")
        return
    phase(name, f"{steps} steps under the profiler: wall {wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), "
          f"idle {100 * (1 - busy_ms / wall_ms):.1f}%")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    flash_ms = sum(e.self_device_time_total for e in ranked if "flash_" in e.key) / 1e3
    sm90_ms = sum(e.self_device_time_total for e in ranked if "_wgmma_" in e.key) / 1e3
    phase(name, f"flash kernels: {flash_ms / steps:.4f} ms/step of device time, "
          f"{100 * flash_ms / busy_ms:.1f}% of the busy time; of it the sm90 family "
          f"(wgmma forward, dQ, dK/dV) {sm90_ms / steps:.4f} ms/step, the CUDA-core "
          f"family {(flash_ms - sm90_ms) / steps:.4f} ms/step")
    for e in ranked[:12]:
        phase(name, f"  {e.self_device_time_total / 1e3 / steps:9.4f} ms/step "
              f"{e.count // steps:4d} calls/step  {e.key[:90]}")
    host = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    host_ms = sum(e.self_cpu_time_total for e in host) / 1e3
    phase(name, f"host: {host_ms / steps:.3f} ms/step of operator time "
          f"(self CPU, under the profiler); the largest:")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]:
        phase(name, f"  {e.self_cpu_time_total / 1e3 / steps:9.4f} ms/step "
              f"{e.count // steps:5d} calls/step  {e.key[:80]}")


# the reference's mesh invariance of seq-sync steps (tests/test_seq_parallel.py:62-79)
SEQ_LOSS_TOL, SEQ_PARAM_TOL = 1e-5, 5e-5
# the seq phase's runs of ptb-transformer-large at its own algo: (name, flags)
SEQ_RUNS = (("ring, sp 1", dict(sp=1)), ("ring, sp 4", dict(sp=4)),
            ("ulysses, sp 4", dict(sp=4, seq_impl="ulysses")))
# a remat run's losses against the same run without remat, relative
REMAT_TOL = 1e-5


def seq_vs_cpu() -> None:
    """One f32 seq-sync step of a narrow 2-layer LM (T = 64, D = 16) at
    (8, 1), and at (2, 4) with ring and Ulysses attention, on the card and
    on the CPU: each agrees with sp = 1 on the card within the reference's
    mesh invariance, and with itself on the CPU within UNIT_TOL."""
    import numpy as np

    from mpit_tpu_torch.comm.topology import Topology
    from mpit_tpu_torch.models import TransformerLM
    from mpit_tpu_torch.optim import SGD
    from mpit_tpu_torch.parallel import SeqParallelTrainer
    from mpit_tpu_torch.utils.params import tree_leaves, tree_map

    rng = np.random.default_rng(0)
    x = rng.integers(0, 97, (WORKERS, 64)).astype(np.int32)
    y = np.roll(x, -1, axis=1)
    params = None
    out = {}
    for dev in ("cuda", "cpu"):
        for impl, shape in (("ring", (8, 1)), ("ring", (2, 4)), ("ulysses", (2, 4))):
            model = TransformerLM(97, num_layers=2, d_model=64, num_heads=4, max_len=64,
                                  compute_dtype=torch.float32, seq_axis="sp",
                                  seq_impl=impl, device=dev)
            if params is None:
                params = model.init(torch.Generator().manual_seed(0))
            topo = Topology(WORKERS, torch.device(dev), axis_names=("dp", "sp"),
                            mesh_shape=shape)
            trainer = SeqParallelTrainer(model, SGD(0.1, momentum=0.9), topo)
            state = trainer.init_state(params=tree_map(torch.clone, params))
            state, m = trainer.step(state, x, y)
            out[dev, impl, shape] = (float(m["loss"]),
                                     [t.cpu() for t in tree_leaves(state.params)])

    def err(a, b):
        return (abs(out[a][0] - out[b][0]),
                max((p - q).abs().max().item() for p, q in zip(out[a][1], out[b][1])))

    one = ("cuda", "ring", (8, 1))
    for key in out:
        if key[0] == "cuda" and key != one:
            loss_err, param_err = err(key, one)
            if loss_err > SEQ_LOSS_TOL or param_err > SEQ_PARAM_TOL:
                raise AssertionError(f"{key[1]} at {key[2]} differs from sp = 1 on the "
                                     f"card: loss {loss_err}, params {param_err}")
            phase("seq", f"f32 2-layer LM, one step, {key[1]} at (dp, sp) = {key[2]} vs "
                  f"(8, 1) on the card: |loss err| {loss_err:.3g} (tolerance "
                  f"{SEQ_LOSS_TOL}), max |param err| {param_err:.3g} ({SEQ_PARAM_TOL})")
        if key[0] == "cuda":
            loss_err, param_err = err(key, ("cpu", *key[1:]))
            if loss_err > UNIT_TOL or param_err > UNIT_TOL:
                raise AssertionError(f"{key[1]} at {key[2]}: card differs from CPU: "
                                     f"loss {loss_err}, params {param_err}")
            phase("seq", f"  {key[1]} at {key[2]}, card vs CPU: |loss err| "
                  f"{loss_err:.3g}, max |param err| {param_err:.3g} (tolerance {UNIT_TOL})")


def train_peak(cfg, steps: int = 2) -> tuple[float, float]:
    """(peak MiB of device memory, ms per step) of ``steps`` training steps
    built as ``run()`` builds them, after one warm-up step, without the
    eval (whose logits would set the peak). The peak counts what the
    training allocates (params, optimizer state, batch, activations) above
    what was allocated before it."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    trainer, state, x, y = built_step(cfg)
    step = sync_step(trainer)
    state, _ = step(state, x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, x, y)
    float(m["loss"])
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / steps
    return (torch.cuda.max_memory_allocated() - base) / 2**20, ms


def seq_path(card_line: str) -> None:
    """``ptb-transformer-large`` with its own algo (seq-sync) at full
    width, W = 8: (8, 1) ring, then (2, 4) ring and Ulysses, 64 steps
    each; then the narrow card-vs-CPU and sp-invariance step."""
    from mpit_tpu_torch.ops import flash_attention as fa
    from mpit_tpu_torch.run import run
    from mpit_tpu_torch.utils.config import TrainConfig

    base = dataclasses.replace(TrainConfig().apply_preset("ptb-transformer-large"),
                               epochs=1, train_size=LM_TRAIN_WINDOWS)
    phase("seq", f"preset ptb-transformer-large, algo {base.algo}: layers {base.layers}, "
          f"d_model {base.d_model}, heads {base.heads}, T {base.seq_len}, global batch "
          f"{base.global_batch}, {base.optimizer} lr {base.lr} {base.lr_schedule}, "
          f"train_size {base.train_size} windows, W = {WORKERS}; {card_line}")
    runs = {}
    for name, over in SEQ_RUNS:
        cfg = dataclasses.replace(base, **over)
        # warm-up; at fewer windows the synthetic corpus's validation split
        # holds fewer than dp windows of T = 512, which no eval batch fills
        run(dataclasses.replace(cfg, train_size=16 * cfg.global_batch))
        for k in fa.launches:
            fa.launches[k] = 0
        res = run(cfg)
        if any(fa.launches.values()):
            raise AssertionError(f"seq-sync launched {fa.launches}: its attention is "
                                 "ring or Ulysses (torch operations), no kernel")
        losses, steps = res["round_losses"], res["trained_units"]
        if steps != LM_TRAIN_WINDOWS // cfg.global_batch or not finite(losses):
            raise AssertionError(f"{name}: {steps} steps, losses {losses}")
        first, last = statistics.mean(losses[:8]), statistics.mean(losses[-8:])
        if not last < first:
            raise AssertionError(f"{name}: loss did not fall: first 8 {first}, last 8 {last}")
        if not (finite([res["eval_loss"]]) and 0.0 <= res["accuracy"] <= 1.0):
            raise AssertionError(f"{name}: eval {res['accuracy']}, {res['eval_loss']}")
        peak, _ = train_peak(cfg)
        if over.get("seq_impl", "ring") == "ring":
            profile_lm(cfg=cfg, name="seq")
        phase("seq", f"{name}: mesh (dp, sp) = ({res['workers']}, {cfg.sp}), {steps} "
              f"steps, {res['samples_per_sec'] * cfg.seq_len:.1f} tokens/s, "
              f"{1e3 * res['wall_s'] / steps:.3f} ms/step; peak device memory of a "
              f"training step {peak:.1f} MiB; losses first 8 {first:.4f}, last 8 "
              f"{last:.4f}; eval accuracy {res['accuracy']:.4f}, eval loss "
              f"{res['eval_loss']:.4f} (per token)")
        runs[name] = losses
    one = runs[SEQ_RUNS[0][0]]
    for name, losses in list(runs.items())[1:]:
        phase("seq", f"{name} against {SEQ_RUNS[0][0]}: max |loss difference| over "
              f"{len(one)} bf16 steps {max(abs(a - b) for a, b in zip(losses, one)):.3g}")
    seq_vs_cpu()


def remat_path(card_line: str) -> dict:
    """``--remat`` against the same run without it: ptb-transformer-large
    sync flash (16 steps) and seq-sync (16 steps), resnet50-sync (8 steps).
    Returns the remat flash run's launches per flash kernel."""
    from mpit_tpu_torch.ops import flash_attention as fa
    from mpit_tpu_torch.run import _ptb_windows, run
    from mpit_tpu_torch.utils.config import TrainConfig

    lm = dataclasses.replace(TrainConfig().apply_preset("ptb-transformer-large"),
                             epochs=1, train_size=16 * 8)
    pairs = (("sync flash", dataclasses.replace(lm, algo="sync", attn_impl="flash")),
             ("seq-sync", lm),
             ("resnet50-sync", TrainConfig().apply_preset("resnet50-sync")))
    flash = None
    phase("remat", card_line)
    for name, cfg in pairs:
        out = {}
        for remat in (False, True):
            c = dataclasses.replace(cfg, remat=remat)
            for k in fa.launches:
                fa.launches[k] = 0
            res = run(c)
            launches = dict(fa.launches)
            peak, peak_ms = train_peak(c)
            out[remat] = res
            phase("remat", f"{name}, remat {remat}: {res['trained_units']} steps, "
                  f"{1e3 * res['wall_s'] / res['trained_units']:.3f} ms/step in the run; "
                  f"a training step alone {peak_ms:.3f} ms, peak device memory "
                  f"{peak:.1f} MiB")
            if name == "sync flash" and remat:
                flash = launches
        a, b = out[False]["round_losses"], out[True]["round_losses"]
        if not finite(a + b) or len(a) != len(b):
            raise AssertionError(f"{name}: losses {a} and {b}")
        rel = max(abs(p - q) / abs(p) for p, q in zip(a, b))
        if rel > REMAT_TOL:
            raise AssertionError(f"{name}: remat losses differ by {rel} relative")
        phase("remat", f"{name}: losses with and without remat "
              f"{'equal bit for bit' if a == b else 'differ'}, max relative "
              f"difference {rel:.3g} (tolerance {REMAT_TOL}) over {len(a)} steps")
    lm_steps = lm.train_size // lm.global_batch
    x_va = _ptb_windows(lm)[2]
    batch = (min(1024, len(x_va)) // WORKERS) * WORKERS
    eval_chunks = (len(x_va) // batch) * -(-batch // 64)
    want = {"flash_forward": 0, "flash_dq": 0, "flash_dkv": 0,
            "flash_forward_sm90": 2 * LM_LAYERS * lm_steps + LM_LAYERS * eval_chunks,
            "flash_dq_sm90": LM_LAYERS * lm_steps, "flash_dkv_sm90": LM_LAYERS * lm_steps}
    if flash != want:
        raise AssertionError(f"remat flash launches {flash} != {want}")
    phase("remat", f"sync flash with remat: flash launches {json.dumps(flash)} = the "
          f"forward twice a step (recomputed in the backward) x {LM_LAYERS} layers x "
          f"{lm_steps} steps + {LM_LAYERS} x {eval_chunks} eval forwards")
    return flash


# --------------------------------------------------------------- A6 phases

# the reference's bench_dp leg (bench.py:763): f32 LeNet, W = 8, 128 per
# worker, SGD 0.05 with momentum 0.9, 64 KiB buckets, 3 warm-up steps
DP_PER_WORKER, DP_BUCKET_BYTES, DP_WARM, DP_STEPS = 128, 64 << 10, 3, 60
# wire bytes a step of LeNet's plan at 64 KiB buckets, W = 8, as the CPU
# tests pin them against the reference's plan
# (tests/test_torch_quant_collectives.py, tests/test_torch_sync.py)
DP_WIRE_BYTES = {"off": 6_861_952, "int8": 1_715_680, "bf16": 3_430_976}
# the zero phase against the lm phase's sync run, per step, relative: one
# card's ZeRO takes the same global-batch gradient and updates a flat
# vector by the same elementwise AdamW
ZERO_TOL = 1e-5


def quant_face_vs_numpy() -> int:
    """The quant torch face on the card against the numpy face, bit for
    bit: random rows of many magnitudes with edge values dropped in, and
    rows of edge values (NaN, ±Inf, -0, subnormals, f32's largest,
    3.39617752923046e+38, where bf16 rounding carries into +inf, an all-zero
    row, an empty set of rows). Returns the cases checked."""
    import numpy as np

    from mpit_tpu_torch import quant

    f32 = np.finfo(np.float32)
    edges = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1.0, 0.5, 2.5, -2.5, 127.5,
                      f32.max, -f32.max, 3.39617752923046e+38, f32.tiny, 1e-40, -3e-42,
                      1e-45], np.float32)
    rng = np.random.default_rng(0)
    cases = [np.tile(edges, (3, 1)), np.zeros((2, 7), np.float32),
             np.zeros((3, 0), np.float32), np.full((2, 5), np.nan, np.float32),
             (rng.standard_normal((5, 17)) * 1e-39).astype(np.float32)]
    for _ in range(24):
        a = (rng.standard_normal((int(rng.integers(1, 9)), int(rng.integers(1, 4096))))
             * np.float32(10.0) ** rng.integers(-30, 30)).astype(np.float32)
        for _ in range(int(rng.integers(0, 6))):
            a[rng.integers(0, a.shape[0]), rng.integers(0, a.shape[1])] = edges[
                rng.integers(len(edges))]
        cases.append(a)

    def same(t, a) -> bool:
        a = np.asarray(a)  # tobytes() is C order, whatever the strides
        got = t.cpu().numpy()
        return got.dtype == a.dtype and got.shape == a.shape and got.tobytes() == a.tobytes()

    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        for a in cases:
            t = torch.from_numpy(a).cuda()
            for mode in ("bf16", "int8"):
                codes, scales = quant.quantize_rows(a, mode)
                tc, ts = quant.quantize_rows_torch(t, mode)
                q = quant.quantize(a, mode)
                wc, ws = quant.quantize_torch(t, mode)
                ok = (same(tc, codes) and same(ts, scales)
                      and same(quant.dequantize_rows_torch(tc, ts, mode),
                               quant.dequantize_rows(codes, scales, mode))
                      and same(wc, q.data) and same(ws, np.float32(q.scale))
                      and same(quant.dequantize_torch(wc, ws, mode), quant.dequantize(q)))
                if not ok:
                    raise AssertionError(f"dp-quant: the {mode} torch face on the card "
                                         f"differs from the numpy face on {a!r}")
    return len(cases)


def dp_leg(mode: str, x, y) -> dict:
    """The bench_dp leg of ``mode`` (``fused`` or a bucketed quant mode) on
    the staged batch: warm-up, then DP_STEPS timed steps."""
    from mpit_tpu_torch.comm.topology import topology
    from mpit_tpu_torch.models import LeNet
    from mpit_tpu_torch.optim import SGD
    from mpit_tpu_torch.parallel import DataParallelTrainer

    kw = {} if mode == "fused" else dict(quant=mode, bucket_bytes=DP_BUCKET_BYTES)
    topo = topology()
    trainer = DataParallelTrainer(LeNet(compute_dtype=torch.float32, device=topo.device),
                                  SGD(0.05, 0.9), topo, **kw)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    losses = []
    for _ in range(DP_WARM):
        state, m = trainer.step(state, x, y)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DP_STEPS):
        state, m = trainer.step(state, x, y)
        losses.append(m["loss"])
    losses = [float(v) for v in losses]  # proves completion
    wall = time.perf_counter() - t0
    return {"samples_per_sec": DP_STEPS * len(x) / wall, "ms_per_step": 1e3 * wall / DP_STEPS,
            "buckets": len(trainer._plan.buckets) if trainer.bucketed else None,
            "wire_bytes_per_step": trainer.wire_bytes_per_step(), "losses": losses}


def dp_quant_path(card_line: str) -> None:
    """The bucketed and quantized sync-DP exchange on the card: the quant
    torch face against the numpy face bit for bit; the reference's bench_dp
    leg fused, raw, int8 and bf16; one f32 int8 step, card vs CPU; then
    ``resnet50-sync`` through ``run()`` at full width under
    ``MPIT_DP_QUANT=int8`` against the fused run."""
    import numpy as np

    from mpit_tpu_torch.data import load_mnist
    from mpit_tpu_torch.models import get_model
    from mpit_tpu_torch.optim import SGD
    from mpit_tpu_torch.parallel import DataParallelTrainer
    from mpit_tpu_torch.run import run
    from mpit_tpu_torch.utils.config import TrainConfig

    phase("dp-quant", f"quant torch face on the card = numpy face, bit for bit, bf16 "
          f"and int8, rows and whole arrays: {quant_face_vs_numpy()} inputs")
    gb = DP_PER_WORKER * WORKERS
    x_tr, y_tr, *_ = load_mnist(synthetic_train=max(2048, gb))
    idx = np.random.default_rng(0).integers(0, len(x_tr), gb)
    x, y = (torch.as_tensor(a[idx]).cuda() for a in (x_tr, y_tr))
    legs = {}
    # the legs repeat one batch at lr 0.05 with momentum 0.9, a chaotic
    # trajectory: under cuDNN's default (nondeterministic) conv backward
    # three runs of the same fused leg ended at losses 3.32, 0.98 and
    # 0.0033, so the falling-loss check below held in some runs only.
    # Deterministic algorithms make each leg one trajectory, run to run.
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for mode in ("fused", "off", "int8", "bf16"):
            leg = legs[mode] = dp_leg(mode, x, y)
            losses = leg.pop("losses")
            if not finite(losses) or not losses[-1] < losses[0]:
                raise AssertionError(f"dp-quant: {mode} losses {losses}")
            if mode != "fused" and leg["wire_bytes_per_step"] != DP_WIRE_BYTES[mode]:
                raise AssertionError(f"dp-quant: {mode} wire bytes "
                                     f"{leg['wire_bytes_per_step']} != {DP_WIRE_BYTES[mode]}")
            phase("dp-quant", f"bench_dp leg {mode} (cudnn.deterministic): {json.dumps(leg)}; "
                  f"loss {losses[0]:.4f} -> {losses[-1]:.4f} over {len(losses)} steps; "
                  f"{card_line}")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    phase("dp-quant", f"int8 vs raw bucketed: {legs['int8']['samples_per_sec'] / legs['off']['samples_per_sec']:.3f}x "
          f"samples/s for {legs['off']['wire_bytes_per_step'] / legs['int8']['wire_bytes_per_step']:.2f}x fewer "
          f"wire bytes; raw bucketed vs fused {legs['off']['samples_per_sec'] / legs['fused']['samples_per_sec']:.3f}x")

    rng = np.random.default_rng(1)
    xs = rng.uniform(0, 1, (WORKERS * 4, 28, 28, 1)).astype(np.float32)
    ys = rng.integers(0, 10, WORKERS * 4).astype(np.int32)
    unit_vs_cpu("dp-quant", lambda dev: get_model("lenet", compute_dtype=torch.float32,
                                                  device=dev),
                lambda m, t: DataParallelTrainer(m, SGD(0.05, 0.9), t, quant="int8",
                                                 bucket_bytes=DP_BUCKET_BYTES), xs, ys)

    cfg = TrainConfig().apply_preset("resnet50-sync")
    fused = run(cfg)
    os.environ["MPIT_DP_QUANT"] = "int8"
    try:
        profile_units("dp-quant", cfg)
        peak, peak_ms = train_peak(cfg)
        trainer, state = built_step(cfg)[:2]
        trainer._ensure_buckets(state.params)
        res = run(cfg)
    finally:
        del os.environ["MPIT_DP_QUANT"]
    a, b = fused["round_losses"], res["round_losses"]
    if not finite(a + b) or len(a) != 8 or len(b) != 8:
        raise AssertionError(f"dp-quant: resnet50-sync losses fused {a}, int8 {b}")
    # the first loss is taken before any update: equal up to the sums' order
    if abs(a[0] - b[0]) > 1e-3 * abs(a[0]):
        raise AssertionError(f"dp-quant: first losses differ: fused {a[0]}, int8 {b[0]}")
    steps = res["trained_units"]
    phase("dp-quant", f"resnet50-sync, MPIT_DP_QUANT=int8, {steps} steps: "
          f"{res['samples_per_sec']:.1f} samples/s, {1e3 * res['wall_s'] / steps:.3f} ms/step "
          f"(fused {1e3 * fused['wall_s'] / fused['trained_units']:.3f}); a training step "
          f"alone {peak_ms:.3f} ms, peak device memory {peak:.1f} MiB; {len(trainer._plan.buckets)} "
          f"buckets, {trainer._plan.wire_bytes_per_step()} wire bytes a step per worker; "
          f"losses int8 {[round(v, 4) for v in b]}, fused {[round(v, 4) for v in a]}; "
          f"{card_line}")


def zero_path(card_line: str, sync_losses: list) -> dict:
    """``ptb-transformer-large --algo zero-sync --attn-impl flash`` at full
    width, cut as the lm phase is: tokens/s, ms per step, peak memory, the
    losses against the lm phase's sync run, the sm90 flash launches; then
    16 steps under ``MPIT_DP_QUANT=int8`` (each worker's own gradient,
    quantized scatter). Returns the flash launches of both runs."""
    from mpit_tpu_torch.ops import flash_attention as fa
    from mpit_tpu_torch.run import _ptb_windows, run

    base = dataclasses.replace(lm_config(), algo="zero-sync")
    x_va = _ptb_windows(base)[2]
    batch = (min(1024, len(x_va)) // WORKERS) * WORKERS
    eval_chunks = (len(x_va) // batch) * -(-batch // 64)
    total = {k: 0 for k in fa.launches}
    for quant, windows in (("off", LM_TRAIN_WINDOWS), ("int8", 16 * 8)):
        cfg = dataclasses.replace(base, train_size=windows)
        os.environ["MPIT_DP_QUANT"] = quant
        try:
            peak, peak_ms = train_peak(cfg)
            for k in fa.launches:
                fa.launches[k] = 0
            res = run(cfg)
            launches = dict(fa.launches)
        finally:
            del os.environ["MPIT_DP_QUANT"]
        steps, losses = res["trained_units"], res["round_losses"]
        want = {"flash_forward": 0, "flash_dq": 0, "flash_dkv": 0,
                "flash_forward_sm90": LM_LAYERS * (steps + eval_chunks),
                "flash_dq_sm90": LM_LAYERS * steps, "flash_dkv_sm90": LM_LAYERS * steps}
        if launches != want:
            raise AssertionError(f"zero: quant {quant}: flash launches {launches} != {want}")
        if not finite(losses):
            raise AssertionError(f"zero: quant {quant}: non-finite loss {losses}")
        first, last = statistics.mean(losses[:8]), statistics.mean(losses[-8:])
        if quant == "off":
            if not last < first:
                raise AssertionError(f"zero: loss did not fall: {first} -> {last}")
            rel = max(abs(p - q) / abs(q) for p, q in zip(losses, sync_losses, strict=True))
            if rel > ZERO_TOL:
                raise AssertionError(f"zero: losses differ from sync's by {rel} relative")
            agree = (f"losses {'equal bit for bit to' if losses == sync_losses else 'differ from'}"
                     f" the lm phase's sync run, max relative difference {rel:.3g} "
                     f"(tolerance {ZERO_TOL})")
        else:
            agree = f"losses first 8 {first:.4f}, last 8 {last:.4f}"
        for k in total:
            total[k] += launches[k]
        phase("zero", f"zero-sync, quant {quant}, {steps} steps: "
              f"{res['samples_per_sec'] * cfg.seq_len:.1f} tokens/s, "
              f"{1e3 * res['wall_s'] / steps:.3f} ms/step in the run; a training step "
              f"alone {peak_ms:.3f} ms, peak device memory {peak:.1f} MiB; {agree}; "
              f"eval loss {res['eval_loss']:.4f}; flash launches {json.dumps(launches)}; "
              f"{card_line}")
    return total


# BASELINE's other four configs (phases vgg, resnet, lstm, alexnet): the
# reference's arithmetic for each preset's units and samples, and what the
# phase holds on the card. ``leg`` is a longer second run where the preset
# is too short to show that the model trains.
BASELINE = {
    "vgg": dict(preset="cifar-vgg-sync", units=96, samples=96 * 256),
    "resnet": dict(preset="resnet50-sync", units=8, samples=8 * 64,
                   leg=dict(train_size=1024, epochs=3)),
    "lstm": dict(preset="ptb-lstm-easgd", units=16, samples=16 * 4 * 128),
    "alexnet": dict(preset="alexnet-downpour", units=2, samples=2 * 4 * 128,
                    leg=dict(train_size=2048, epochs=2)),
}
# one f32 step or round, card against CPU, from the same init: the centers
# or params after it agree within this (f32 sums run in other orders)
UNIT_TOL = 1e-4


def finite(values) -> bool:
    return all(v == v and abs(v) != float("inf") for v in values)


def falls(losses) -> tuple[float, float]:
    """(first, last) quarter means of a run's losses; asserts last < first."""
    q = max(len(losses) // 4, 1)
    first, last = statistics.mean(losses[:q]), statistics.mean(losses[-q:])
    if not last < first:
        raise AssertionError(f"loss did not fall: first quarter {first}, last {last}")
    return first, last


def unit_vs_cpu(name: str, make_model, make_trainer, x, y) -> None:
    """One f32 step (sync) or round (τ-round trainers) of ``make_model`` on
    the card against the same on the CPU, from the same init and batch."""
    from mpit_tpu_torch.comm.topology import Topology
    from mpit_tpu_torch.utils.params import tree_leaves, tree_map

    params = make_model("cpu").init(torch.Generator().manual_seed(0))
    out, losses = {}, {}
    for dev in ("cuda", "cpu"):
        trainer = make_trainer(make_model(dev), Topology(WORKERS, torch.device(dev)))
        state = trainer.init_state(params=tree_map(torch.clone, params))
        state, m = trainer.step(state, x, y)
        held = state.params if hasattr(state, "params") else trainer.center_params(state)
        out[dev] = [t.cpu() for t in tree_leaves(held)]
        losses[dev] = float(m["loss"])
    err = max((a - b).abs().max().item() for a, b in zip(out["cuda"], out["cpu"]))
    if not err <= UNIT_TOL or abs(losses["cuda"] - losses["cpu"]) > UNIT_TOL:
        raise AssertionError(f"{name}: card differs from CPU: params {err}, losses {losses}")
    phase(name, f"f32, one {'step' if hasattr(state, 'params') else 'round'}, card vs "
          f"CPU: max |param err| {err:.3g}, loss {losses['cuda']:.6f} vs "
          f"{losses['cpu']:.6f} (tolerance {UNIT_TOL})")


def baseline_checks(name: str) -> None:
    """The f32 card-vs-CPU unit of a BASELINE phase, at a small size."""
    import numpy as np

    from mpit_tpu_torch.models import get_model
    from mpit_tpu_torch.optim import SGD
    from mpit_tpu_torch.parallel import DataParallelTrainer, DownpourTrainer, EASGDTrainer

    rng = np.random.default_rng(0)
    f32 = torch.float32

    def images(tau, size, classes):
        shape = (tau, WORKERS * 2, size, size, 3) if tau else (WORKERS, size, size, 3)
        x = rng.uniform(0, 1, shape).astype(np.float32)
        return x, rng.integers(0, classes, shape[:-3]).astype(np.int32)

    if name == "vgg":
        unit_vs_cpu(name, lambda dev: get_model("vgg", compute_dtype=f32, device=dev),
                    lambda m, t: DataParallelTrainer(m, SGD(0.02, 0.9), t),
                    *images(0, 32, 10))
    elif name == "resnet":
        unit_vs_cpu(name, lambda dev: get_model(
                        "resnet50", stage_sizes=(1, 1, 1, 1), in_shape=(64, 64, 3),
                        compute_dtype=f32, device=dev),
                    lambda m, t: DataParallelTrainer(m, SGD(0.1, 0.9), t),
                    *images(0, 64, 1000))
    elif name == "alexnet":
        unit_vs_cpu(name, lambda dev: get_model(
                        "alexnet", in_shape=(64, 64, 3), compute_dtype=f32, device=dev),
                    lambda m, t: DownpourTrainer(m, SGD(0.01, 0.9), t, tau=2,
                                                 staleness=1),
                    *images(2, 64, 1000))
    else:
        tokens = rng.integers(0, 97, (2, WORKERS * 2, 33))
        unit_vs_cpu(name, lambda dev: get_model(
                        "lstm", vocab_size=97, embed_dim=32, hidden=64,
                        compute_dtype=f32, device=dev),
                    lambda m, t: EASGDTrainer(m, SGD(1.0), t, tau=2),
                    tokens[..., :-1].astype(np.int32), tokens[..., 1:].astype(np.int32))


def profile_units(name: str, cfg, units: int = 3) -> None:
    """Where a step's or a round's time goes: ``torch.profiler`` over a few
    units of ``cfg``'s trainer, built as ``run()`` builds it, on random
    inputs of the preset's shapes, after two warm-up units (which also warm
    cuDNN's and the allocator's first calls up for the timed run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mpit_tpu_torch.comm.topology import topology
    from mpit_tpu_torch.run import _image_shape, build_model, build_optimizer, build_trainer

    topo = topology()
    trainer = build_trainer(cfg, build_model(cfg, topo.device), build_optimizer(cfg), topo)
    state = trainer.init_state(torch.Generator().manual_seed(cfg.seed))
    gen = torch.Generator(device="cuda").manual_seed(0)
    sync = cfg.resolved_algo() == "sync"
    lead = (cfg.global_batch,) if sync else (
        WORKERS, cfg.tau, cfg.global_batch // WORKERS)
    if cfg.dataset == "ptb":
        x = torch.randint(0, 10_000, (*lead, cfg.seq_len), generator=gen, device="cuda")
        y = torch.randint(0, 10_000, (*lead, cfg.seq_len), generator=gen, device="cuda")
    else:
        classes = 1000 if cfg.dataset == "imagenet" else 10
        x = torch.rand((*lead, *_image_shape(cfg)), generator=gen, device="cuda")
        y = torch.randint(0, classes, lead, generator=gen, device="cuda")
    unit = sync_step(trainer) if sync else trainer._round
    for _ in range(2):
        state, _ = unit(state, x, y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(units):
            state, m = unit(state, x, y)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    what = "step" if sync else "round"
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    union_ms, sum_ms = busy_union_ms(prof)
    if union_ms == 0:
        phase(name, "device busy time: not measured (no device events)")
        return
    phase(name, f"{units} {what}s under the profiler: wall {wall_ms:.3f} ms, device busy "
          f"{union_ms:.3f} ms ({100 * union_ms / wall_ms:.1f}%, overlaps counted once), "
          f"idle {100 * (1 - union_ms / wall_ms):.1f}%; {sum_ms / units:.3f} ms of device "
          f"time per {what} (summed over streams)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        phase(name, f"  {e.self_device_time_total / 1e3 / units:9.4f} ms/{what} "
              f"{e.count // units:5d} calls/{what}  {e.key[:90]}")
    # cuDNN's weight-gradient kernels: grouped ones run where a vmap batches
    # convs over per-worker weights or per-worker inputs
    wgrad = [e for e in kernels if "wgrad" in e.key.lower()]
    phase(name, f"cuDNN wgrad kernels: {sum(e.count for e in wgrad) // units} calls/{what}, "
          f"{sum(e.self_device_time_total for e in wgrad) / 1e3 / units:.4f} ms/{what}; "
          + "; ".join(sorted({e.key[:70] for e in wgrad})[:4]))


def baseline_path(name: str, card_line: str) -> int:
    """One of BASELINE's configs through ``run()`` on the card at its
    preset's width and ``train_size``: the f32 card-vs-CPU unit, a profile
    of a few units (the warm-up), the timed run held to the reference's
    units and samples, finite losses, and a loss that falls (here or in the
    longer leg). Returns the elastic launches of the timed run."""
    from mpit_tpu_torch.ops import elastic
    from mpit_tpu_torch.run import run
    from mpit_tpu_torch.utils.config import TrainConfig

    t_phase = time.perf_counter()
    want = BASELINE[name]
    cfg = TrainConfig().apply_preset(want["preset"])
    phase(name, f"preset {cfg.preset}: {cfg.model} on {cfg.dataset}, {cfg.algo}, lr "
          f"{cfg.lr}, momentum {cfg.momentum}, global batch {cfg.global_batch}, "
          f"train_size {cfg.train_size}, epochs {cfg.epochs}"
          + ("" if cfg.algo == "sync" else f", tau {cfg.tau}, W = {WORKERS}")
          + (f", staleness {cfg.staleness}" if cfg.algo == "downpour" else ""))
    baseline_checks(name)
    profile_units(name, cfg)

    elastic.launches = 0
    res = run(cfg)
    launches = elastic.launches
    units, losses = res["trained_units"], res["round_losses"]
    if (units, res["samples"]) != (want["units"], want["samples"]):
        raise AssertionError(f"{name}: {units} units, {res['samples']} samples, not "
                             f"{want['units']} and {want['samples']}")
    if not finite(losses):
        raise AssertionError(f"{name}: non-finite loss: {losses}")
    if cfg.algo == "easgd" and launches != units:
        raise AssertionError(f"{name}: elastic launches {launches} != rounds {units}")
    what = "step" if cfg.algo == "sync" else "round"
    rate = f"{res['samples_per_sec']:.1f} samples/s"
    if cfg.dataset == "ptb":
        rate += f", {res['samples_per_sec'] * cfg.seq_len:.1f} tokens/s"
    phase(name, json.dumps({k: res.get(k) for k in (
        "accuracy", "eval_loss", "final_loss", "round_losses", "trained_units",
        "samples", "wall_s", "samples_per_sec")}))
    phase(name, f"{units} {what}s, {res['samples']} samples: {rate}, "
          f"{1e3 * res['wall_s'] / units:.3f} ms per {what}; elastic launches "
          f"{launches}{' = rounds' if cfg.algo == 'easgd' else ''}; {card_line}")
    if "leg" in want:
        leg = dataclasses.replace(cfg, **want["leg"])
        res = run(leg)
        losses = res["round_losses"]
        if not finite(losses):
            raise AssertionError(f"{name}: non-finite loss in the leg: {losses}")
        phase(name, f"longer leg (train_size {leg.train_size}, epochs {leg.epochs}): "
              f"{res['trained_units']} {what}s, {res['samples_per_sec']:.1f} samples/s")
    first, last = falls(losses)
    phase(name, f"loss falls: first quarter {first:.4f}, last quarter {last:.4f}; "
          f"accuracy {res['accuracy']:.4f}; phase {time.perf_counter() - t_phase:.1f} s")
    return launches


# --------------------------------------------------------------- A5b phases


def _same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x, y = fa.read(1 << 24), fb.read(1 << 24)
            if x != y:
                return False
            if not x:
                return True


def _differing_leaves(a: str, b: str) -> list:
    """The leaves of two checkpoint files that differ, with their largest
    difference (to name what a mismatch comes from)."""
    import numpy as np

    from mpit_tpu_torch.utils.checkpoint import msgpack_restore

    def walk(tree, path=""):
        if isinstance(tree, dict):
            for k in tree:
                yield from walk(tree[k], f"{path}/{k}")
        else:
            yield path, np.asarray(tree)

    with open(a, "rb") as fa, open(b, "rb") as fb:
        want, got = dict(walk(msgpack_restore(fa.read()))), dict(walk(msgpack_restore(fb.read())))
    return [(k, float(np.abs(want[k].astype(float) - got[k]).max()))
            for k in want if not np.array_equal(want[k], got[k])][:12]


def _preempted(cfg, ckpt_dir: str, mid: int) -> str:
    """A copy of the straight run's checkpoint ``mid`` (and its metadata) in
    a fresh directory: what a job preempted after unit ``mid`` leaves."""
    import shutil

    os.makedirs(ckpt_dir)
    for ext in ("msgpack", "json"):
        shutil.copy(os.path.join(cfg.ckpt_dir, f"ckpt_{mid:08d}.{ext}"), ckpt_dir)
    return ckpt_dir


def resume_easgd() -> dict:
    """``mnist-easgd`` at W = 8 with the cosine schedule and clip_norm 1.0:
    two epochs straight, checkpointing every epoch, then a run resumed from
    a copy of the straight run's first-epoch checkpoint (a preempted job:
    the cosine's horizon is the whole run, so a separate one-epoch run
    would follow another schedule). The final ``ckpt_00000016`` files are
    byte-equal, and the resumed leg launches the elastic kernel once per
    round."""
    import tempfile

    from mpit_tpu_torch.ops import elastic
    from mpit_tpu_torch.run import run
    from mpit_tpu_torch.utils.config import TrainConfig

    base = dataclasses.replace(TrainConfig().apply_preset("mnist-easgd"), epochs=2,
                               lr_schedule="cosine", clip_norm=1.0)
    with tempfile.TemporaryDirectory(prefix="resume-easgd-") as tmp:
        straight = dataclasses.replace(base, ckpt_dir=os.path.join(tmp, "a"), ckpt_every=8)
        a = run(straight)
        total = a["last_checkpoint"]
        mid = total // 2
        resumed = dataclasses.replace(
            base, resume=True, ckpt_dir=_preempted(straight, os.path.join(tmp, "b"), mid))
        elastic.launches = 0
        b = run(resumed)
        launches = elastic.launches
        fa, fb = (os.path.join(d, f"ckpt_{total:08d}.msgpack")
                  for d in (straight.ckpt_dir, resumed.ckpt_dir))
        if total != 16 or b["resumed_from"] != mid or b["trained_units"] != total - mid:
            raise AssertionError(f"resume-easgd: units {total}, resumed from "
                                 f"{b['resumed_from']}, {b['trained_units']} trained")
        if not _same_bytes(fa, fb):
            raise AssertionError(f"resume-easgd: the resumed state differs from the "
                                 f"straight one: {_differing_leaves(fa, fb)}")
        size = os.path.getsize(fa)
        if launches != b["trained_units"]:
            raise AssertionError(f"resume-easgd: elastic launches {launches} != "
                                 f"{b['trained_units']} rounds")
    phase("resume-easgd", f"mnist-easgd W=8, cosine, clip_norm 1.0: straight 2 epochs "
          f"({a['trained_units']} rounds, {1e3 * a['wall_s'] / a['trained_units']:.3f} "
          f"ms/round) and resumed from round {mid} ({b['trained_units']} rounds, "
          f"{1e3 * b['wall_s'] / b['trained_units']:.3f} ms/round): "
          f"ckpt_{total:08d}.msgpack byte-equal ({size} bytes); elastic launches in the "
          f"resumed leg {launches} = its rounds; losses {b['round_losses']}")
    return dict(launches=launches)


def resume_lm(card_line: str) -> dict:
    """``ptb-transformer-large --algo sync --attn-impl flash`` at full width
    with clip_norm 1.0 and the preset's warmup-cosine, 128 windows (16
    steps an epoch), two epochs: straight with a checkpoint every epoch,
    then resumed from a copy of its first-epoch checkpoint (the schedule's
    horizon is the whole run). The final states are byte-equal; the
    resumed leg launches the sm90 flash kernels 6 x 16 times (plus the
    eval forwards); the checkpoint's size and its save and restore times
    are printed. The files go to a temporary directory the phase removes."""
    import tempfile

    from mpit_tpu_torch.comm.topology import topology
    from mpit_tpu_torch.ops import flash_attention as fa
    from mpit_tpu_torch.run import _ptb_windows, build_model, build_optimizer, build_trainer, run
    from mpit_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

    base = dataclasses.replace(lm_config(), train_size=128, epochs=2, clip_norm=1.0)
    with tempfile.TemporaryDirectory(prefix="resume-lm-") as tmp:
        straight = dataclasses.replace(base, ckpt_dir=os.path.join(tmp, "a"), ckpt_every=16)
        a = run(straight)
        total = a["last_checkpoint"]
        mid = total // 2
        resumed = dataclasses.replace(
            base, resume=True, ckpt_dir=_preempted(straight, os.path.join(tmp, "b"), mid))
        for k in fa.launches:
            fa.launches[k] = 0
        b = run(resumed)
        launches = dict(fa.launches)
        steps = b["trained_units"]
        x_va = _ptb_windows(base)[2]
        batch = (min(1024, len(x_va)) // WORKERS) * WORKERS
        eval_chunks = len(x_va) // batch * -(-batch // 64)
        want = {"flash_forward": 0, "flash_dq": 0, "flash_dkv": 0,
                "flash_forward_sm90": LM_LAYERS * (steps + eval_chunks),
                "flash_dq_sm90": LM_LAYERS * steps, "flash_dkv_sm90": LM_LAYERS * steps}
        if total != 32 or b["resumed_from"] != 16 or steps != 16:
            raise AssertionError(f"resume-lm: units {total}, resumed from "
                                 f"{b['resumed_from']}, {steps} steps")
        if not all(v == v and abs(v) != float("inf") for v in b["round_losses"]):
            raise AssertionError(f"resume-lm: non-finite loss {b['round_losses']}")
        f_a, f_b = (os.path.join(d, f"ckpt_{total:08d}.msgpack")
                    for d in (straight.ckpt_dir, resumed.ckpt_dir))
        if not _same_bytes(f_a, f_b):
            raise AssertionError(f"resume-lm: the resumed state differs from the "
                                 f"straight one: {_differing_leaves(f_a, f_b)}")
        if launches != want:
            raise AssertionError(f"resume-lm: flash launches {launches} != {want}")
        size = os.path.getsize(f_a)
        # save and restore of this state, timed on their own
        topo = topology()
        meta = _ptb_windows(dataclasses.replace(base, train_size=8))[4]
        trainer = build_trainer(base, build_model(base, topo.device, meta),
                                build_optimizer(base, total), topo)
        template = trainer.init_state(torch.Generator().manual_seed(base.seed))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, step = restore_checkpoint(resumed.ckpt_dir, template)
        torch.cuda.synchronize()
        restore_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        path = save_checkpoint(os.path.join(tmp, "c"), state, step)
        save_ms = 1e3 * (time.perf_counter() - t0)
        if step != total or not _same_bytes(path, f_b):
            raise AssertionError("resume-lm: a restore and save of the final state "
                                 "does not give its file back")
    phase("resume-lm", f"full width, 2 epochs of 16 steps, clip_norm 1.0, "
          f"{base.lr_schedule}: straight {1e3 * a['wall_s'] / a['trained_units']:.3f} "
          f"ms/step, resumed from step {mid} {1e3 * b['wall_s'] / steps:.3f} ms/step "
          f"(both with their checkpoint saves); ckpt_{total:08d}.msgpack byte-equal; "
          f"flash launches in the resumed leg {json.dumps(launches)}")
    phase("resume-lm", f"checkpoint {size} bytes ({size / 2**20:.1f} MiB: params, "
          f"AdamW's mu and nu, counts); save {save_ms:.1f} ms, restore {restore_ms:.1f} "
          f"ms ({size / 2**30 / (save_ms / 1e3):.2f} / "
          f"{size / 2**30 / (restore_ms / 1e3):.2f} GiB/s); {card_line}")
    return launches


def ps_resume() -> None:
    """``mnist-ps`` with ``ckpt_dir``, then again with ``resume``: the second
    run restores the servers' persisted center chunks, both runs keep the
    reference's counts, and the final ``ps_center`` checkpoint loads."""
    import tempfile

    from mpit_tpu_torch.comm.topology import topology
    from mpit_tpu_torch.run import build_model, run
    from mpit_tpu_torch.utils.checkpoint import restore_checkpoint
    from mpit_tpu_torch.utils.config import TrainConfig

    cfg = TrainConfig().apply_preset("mnist-ps")
    rounds = cfg.steps // cfg.tau
    want = {"push_easgd": cfg.clients * rounds, "fetch": cfg.clients * (rounds + 1)}
    with tempfile.TemporaryDirectory(prefix="ps-resume-") as tmp:
        cfg = dataclasses.replace(cfg, ckpt_dir=tmp)
        first = run(cfg)
        again = run(dataclasses.replace(cfg, resume=True))
        for name, r, restored in (("first", first, False), ("resumed", again, True)):
            got = {k: r["server_counts"][0][k] for k in want}
            if got != want or r["dead_clients"] or r["center_restored"] != restored:
                raise AssertionError(f"ps-resume: {name} run: counts {got} != {want}, "
                                     f"dead {r['dead_clients']}, center_restored "
                                     f"{r['center_restored']}")
        with open(os.path.join(tmp, f"ckpt_{cfg.steps:08d}.json")) as f:
            kind = json.load(f)["kind"]
        template = build_model(cfg, topology().device).init(torch.Generator().manual_seed(1))
        center, step = restore_checkpoint(tmp, template)
        if kind != "ps_center" or step != cfg.steps:
            raise AssertionError(f"ps-resume: checkpoint kind {kind}, step {step}")
    phase("ps-resume", f"mnist-ps with ckpt_dir: first run {want}, center_restored "
          f"False, accuracy {first['accuracy']}; resumed run {want}, center_restored "
          f"True, accuracy {again['accuracy']}; ckpt_{cfg.steps:08d}.msgpack (kind "
          f"ps_center) loads into LeNet's tree on {topology().device}")


def profile_phase() -> None:
    """``mnist-easgd`` for one epoch with ``profile_dir``: the trace holds
    the card's kernels, the elastic kernel once per round."""
    import tempfile

    from mpit_tpu_torch.run import run
    from mpit_tpu_torch.utils.config import TrainConfig

    cfg = dataclasses.replace(TrainConfig().apply_preset("mnist-easgd"), epochs=1)
    with tempfile.TemporaryDirectory(prefix="profile-") as tmp:
        res = run(dataclasses.replace(cfg, profile_dir=tmp))
        names = os.listdir(tmp)
        if len(names) != 1 or not names[0].endswith(".pt.trace.json"):
            raise AssertionError(f"profile: {names} in the profile directory")
        with open(os.path.join(tmp, names[0])) as f:
            events = json.load(f)["traceEvents"]
        size = os.path.getsize(os.path.join(tmp, names[0]))
    kernels = [e for e in events if e.get("cat") == "kernel"]
    elastic = [e for e in kernels if "elastic_update_kernel(" in e.get("name", "")]
    rounds = res["trained_units"]
    if not kernels or len(elastic) != rounds:
        raise AssertionError(f"profile: {len(kernels)} kernel events, {len(elastic)} of "
                             f"the elastic kernel for {rounds} rounds")
    phase("profile-dir", f"mnist-easgd 1 epoch with profile_dir: {names[0]} ({size} "
          f"bytes), {len(events)} events, {len(kernels)} CUDA kernel events, "
          f"elastic_update_kernel {len(elastic)} = {rounds} rounds")


DIST_TIMEOUT_S = 300


def dist_phase() -> None:
    """The process world through the launcher: one rank on the card (NCCL)
    of ``multihost_sync.py --algo sync`` and ``--algo zero`` (ZeRO-1, Adam),
    and two ranks on the CPU (gloo) of ``--algo sync``; each exits 0 with
    the reference's worker count, the ranks' losses are equal and the
    checkpoint round trip is bit-exact. One card cannot run NCCL across
    ranks."""
    import tempfile

    script = os.path.join("mpit_tpu_torch", "examples", "multihost_sync.py")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MPIT_", "JAX_COORDINATOR", "CUDA_VISIBLE"))}
    env["CUDA_VISIBLE_DEVICES"] = os.environ["CUDA_VISIBLE_DEVICES"]
    with tempfile.TemporaryDirectory(prefix="dist-") as tmp:
        for n, extra, backend, algo in ((1, [], "nccl", "sync"), (1, [], "nccl", "zero"),
                                        (2, ["--device", "cpu"], "gloo", "sync")):
            out = os.path.join(tmp, f"n{n}-{algo}")
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "mpit_tpu_torch.launch", "-n", str(n),
                 "--jax-distributed", script, "--algo", algo, "--steps", "40",
                 "--ckpt-dir", os.path.join(tmp, f"ck{n}-{algo}"), "--out", out, *extra],
                cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                capture_output=True, text=True, timeout=DIST_TIMEOUT_S)
            wall = time.perf_counter() - t0
            if r.returncode != 0:
                raise AssertionError(f"dist: -n {n} exited {r.returncode}:\n"
                                     f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
            ranks = []
            for i in range(n):
                with open(f"{out}.rank{i}.json") as f:
                    ranks.append(json.load(f))
            if ([m["num_workers"] for m in ranks] != [n] * n
                    or len({m["last_loss"] for m in ranks}) != 1
                    or not all(m["ckpt_roundtrip"] for m in ranks)
                    or not ranks[0]["last_loss"] < ranks[0]["first_loss"]):
                raise AssertionError(f"dist: -n {n}: {ranks}")
            device = "cuda" if n == 1 else "cpu"
            if f"device={device}" not in r.stdout:
                raise AssertionError(f"dist: -n {n} did not run on {device}:\n{r.stdout}")
            phase("dist", f"launch -n {n} --jax-distributed multihost_sync.py --algo "
                  f"{algo} ({backend}, {device}): exit 0 in {wall:.3f} s; num_workers "
                  f"{ranks[0]['num_workers']}; loss {ranks[0]['first_loss']:.4f} -> "
                  f"{ranks[0]['last_loss']:.4f} on every rank; checkpoint round trip "
                  f"bit-exact on every rank")


SERVE_SEED = 13
# where the serving phases run (the card; a rehearsal on the CPU patches it)
SERVE_DEVICE = "cuda"
SERVE_VOCAB = 10_000
SERVE_MAX_LEN = 512
SERVE_REQS = 8
SERVE_NEW = 64
SERVE_BATCH, SERVE_SEGMENT = 8, 16
SERVE_SAMPLED = dict(temperature=0.8, top_p=0.95)
SPEC_K = 4
# the f32 logits of the serving model, card vs the port on the CPU: the
# transformer tests' limit (tests/test_torch_transformer.py:30)
SERVE_F32_TOL = dict(rtol=2e-5, atol=2e-5)
# the load run's schedule: 64 requests at 50 a second, prompts mostly short,
# a tenth long, 16-63 new tokens each
SERVE_LOAD = dict(requests=64, rate=50, prompt_buckets=((8, 64, 0.5), (64, 256, 0.4),
                                                        (256, 448, 0.1)),
                  output_buckets=((16, 64, 1.0),))
RNN_FLOATS = 11_364_112  # ptb-lstm-easgd's LSTM (vocab 10,000, 256, 512, 2 layers)
# ROADMAP C8: the decode path runs every token product at a row count that
# neither the batch nor the caller sets (models/layers.py ROW_BLOCK), so a
# served row equals its solo call bit for bit. What still runs at other
# shapes by design (the speculative verification chunk against a tick, a
# prefix template's chunk against the whole prompt's) may part where the
# two best scores lie this close (the largest gap at a first divergence on
# an H100 80GB HBM3 at 700 W was 0.0079 before the row blocks)
NEAR_TIE = 2.0**-5
# the serve phase's costs before the row blocks (PERF.md section 6: three
# chip calls on an H100 80GB HBM3 at 700 W): ms and launches a tick of the
# profiled segment, the load run's TTFT and generated tokens/s
SERVE_BEFORE_BLOCKS = dict(tick_ms="8.286-10.705", launches="447.8-450.3",
                  ttft_p50_ms="1617.7-2368.5", ttft_p99_ms="2865.9-3814.5",
                  tokens_per_s="406.2-531.8")
SERVE_PREFIX = 24  # tokens of the shared prefix in the prefix count
# the flash model's logits against the xla model's: bf16 models' limit
# (tests/test_torch_transformer.py:36); FLASH_TOL bounds one attention's
# output, and six bf16 layers carry the sm90 kernel's bf16 P further
SERVE_BF16_TOL = dict(rtol=5e-2, atol=5e-2)


def serve_model(dtype=torch.bfloat16, attn_impl="xla"):
    """``ptb-transformer-large``'s model at full width, built for serving."""
    from mpit_tpu_torch.models.transformer import TransformerLM

    return TransformerLM(SERVE_VOCAB, num_layers=LM_LAYERS, d_model=768, num_heads=12,
                         max_len=SERVE_MAX_LEN, compute_dtype=dtype,
                         attn_impl=attn_impl, device=SERVE_DEVICE)


def serve_requests() -> list:
    """SERVE_REQS prompts of 16-199 tokens from a seed, SERVE_NEW tokens each."""
    import numpy as np

    rng = np.random.default_rng(SERVE_SEED)
    return [([int(t) for t in rng.integers(1, SERVE_VOCAB, int(rng.integers(16, 200)))],
             SERVE_NEW) for _ in range(SERVE_REQS)]


def first_divergence(a: list, b: list):
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)


def divergence_gap(model, params, seq: list, j: int, other: int, key=None,
                   temp=None) -> float:
    """The gap between the two tokens decoded at position ``j`` (``seq[j]``
    and ``other``) in the scores the draw compared: the model's logits
    after ``seq[:j]`` (divided by the temperature plus the request's Gumbel
    noise for that token, when sampled)."""
    from mpit_tpu_torch import random as jrandom

    with torch.no_grad():
        logits = model.apply(params, torch.tensor([seq[:j]], device=SERVE_DEVICE))[0, -1]
    if key is not None:
        logits = logits / temp + jrandom.gumbel(key[None], (logits.shape[-1],))[0]
    return abs(float(logits[seq[j]] - logits[other]))


def check_near_ties(name: str, diverged: list) -> None:
    """ROADMAP C8: every divergence from a solo call starts at a near-tie."""
    far = [d for d in diverged if not d[-1] <= NEAR_TIE]
    if far:
        raise AssertionError(f"{name}: divergences past a near-tie ({NEAR_TIE}): {far}")


def serve_consistency(model, params, reqs, rule: dict, label: str) -> dict:
    """The reqs through ``Server(max_batch=8, segment=16)`` against their
    solo ``generate_fast`` calls: every one bit-equal (ROADMAP C8, closed
    for these), or the first divergences, with their gaps, in the error.
    Returns the server's results."""
    from mpit_tpu_torch import random as jrandom
    from mpit_tpu_torch.models import Server, generate_fast

    srv = Server(model, params, max_batch=SERVE_BATCH, segment=SERVE_SEGMENT,
                 device=SERVE_DEVICE, **rule)
    rids = [srv.submit(p, mn, rng=jrandom.key(1000 + i)) for i, (p, mn) in enumerate(reqs)]
    t0 = time.perf_counter()
    got = srv.drain()
    wall = time.perf_counter() - t0
    diverged = []
    for i, (rid, (p, mn)) in enumerate(zip(rids, reqs)):
        solo = generate_fast(model, params, p, mn, rng=jrandom.key(1000 + i),
                             device=SERVE_DEVICE, **rule)
        j = first_divergence(solo, got[rid])
        if j is None:
            continue
        key = None
        if rule:
            key = jrandom.split(jrandom.key(1000 + i, SERVE_DEVICE), mn)[j - len(p)]
        gap = divergence_gap(model, params, solo, j, got[rid][j], key,
                             rule.get("temperature"))
        diverged.append((i, j - len(p), gap))
    if diverged:
        raise AssertionError(f"serve: {label}: {SERVE_REQS - len(diverged)} of {SERVE_REQS} "
                             f"bit-equal to their solo generate_fast; divergences "
                             f"(request, generated token, gap): {diverged}")
    phase("serve", f"{label}: {SERVE_REQS} requests ({', '.join(str(len(p)) for p, _ in reqs)} "
          f"prompt tokens, {SERVE_NEW} new each) through Server(max_batch={SERVE_BATCH}, "
          f"segment={SERVE_SEGMENT}) in {wall:.3f} s: {SERVE_REQS} of {SERVE_REQS} "
          f"bit-equal to their solo generate_fast (before the row blocks: 5 of 8 "
          f"greedy, 7 of 8 sampled)")
    return {i: got[r] for i, r in enumerate(rids)}


def serve_prefix_count(model, params, reqs) -> None:
    """ROADMAP C8, what is left: requests behind a shared prefix (its
    template prefilled once, each suffix a chunk of its own bucket)
    against solo ``generate_fast`` on prefix + prompt, which prefills the
    whole at another shape; the count equal, each divergence at a
    near-tie."""
    from mpit_tpu_torch.models import Server, generate_fast

    prefix = [int(t) for t in reqs[-1][0][:SERVE_PREFIX]]
    few = [(p[:40], 16) for p, _ in reqs[:4]]
    srv = Server(model, params, max_batch=SERVE_BATCH, segment=SERVE_SEGMENT,
                 prefix=prefix, device=SERVE_DEVICE)
    rids = [srv.submit(p, mn) for p, mn in few]
    got = srv.drain()
    diverged = []
    for i, (rid, (p, mn)) in enumerate(zip(rids, few)):
        solo = generate_fast(model, params, prefix + p, mn, device=SERVE_DEVICE)
        j = first_divergence(solo, got[rid])
        if j is not None:
            diverged.append((i, j - len(prefix) - len(p),
                             divergence_gap(model, params, solo, j, got[rid][j])))
    check_near_ties("serve", diverged)
    phase("serve", f"prefix= ({SERVE_PREFIX} tokens, prefilled once as a template): "
          f"{len(few) - len(diverged)} of {len(few)} requests (16 new "
          f"each, greedy) bit-equal to solo generate_fast on prefix + prompt; divergences "
          f"(request, generated token, gap): {diverged}")


def serve_vs_cpu(params, prompt: list) -> None:
    """The f32 serving model's prefill logits and first tick's logits on
    the card against the port on the CPU, from the same params and tokens."""
    from mpit_tpu_torch.models import sampling
    from mpit_tpu_torch.utils.params import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    dec = serve_model(torch.float32).clone(decode=True)
    out = {}
    tok = None
    for dev in (SERVE_DEVICE, "cpu"):
        p = tree_map(lambda t: t.to(dev), params)
        buf = torch.tensor([prompt], device=dev)
        lens = torch.tensor([len(prompt)], dtype=torch.int32, device=dev)
        with torch.no_grad():
            cache, last = sampling._prefill_chunk(dec, p, dec.init_cache(1, dev), buf, lens)
            if tok is None:
                tok = int(torch.argmax(last[0]))
            logits, _ = dec.apply(p, torch.tensor([[tok]], device=dev), cache)
        out[dev] = (last.cpu(), logits[:, 0].cpu())
    errs = []
    for a, b in zip(out[SERVE_DEVICE], out["cpu"]):
        torch.testing.assert_close(a, b, **SERVE_F32_TOL)
        errs.append((a - b).abs().max().item())
    phase("serve", f"f32 prefill ({len(prompt)} tokens) and first tick, card vs CPU: max "
          f"|logit err| {errs[0]:.3g} and {errs[1]:.3g} (rtol {SERVE_F32_TOL['rtol']}, atol "
          f"{SERVE_F32_TOL['atol']})")


def serve_load(model, params, card_line: str) -> None:
    """The open-loop load run with obs on, read by ``obs slo``; then one
    full segment under the profiler."""
    import tempfile

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mpit_tpu_torch.loadgen import LoadHarness, LoadSpec, make_workload
    from mpit_tpu_torch.models import Server
    from mpit_tpu_torch.obs.core import ObsConfig
    from mpit_tpu_torch.utils.params import tree_leaves

    old = SERVE_BEFORE_BLOCKS

    def work():
        return make_workload(LoadSpec(**SERVE_LOAD), SERVE_VOCAB, max_len=SERVE_MAX_LEN)

    warm = Server(model, params, max_batch=SERVE_BATCH, segment=SERVE_SEGMENT,
                  device=SERVE_DEVICE)
    for r in work():
        warm.submit(list(r.prompt), r.max_new)
    warm.drain()
    kv_bytes = SERVE_BATCH * LM_LAYERS * 2 * SERVE_MAX_LEN * 768 * 2
    with tempfile.TemporaryDirectory(prefix="serve-") as tmp:
        srv = Server(model, params, max_batch=SERVE_BATCH, segment=SERVE_SEGMENT,
                     device=SERVE_DEVICE, obs=ObsConfig(dir=tmp))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()  # what earlier phases still hold
        torch.cuda.reset_peak_memory_stats()
        rep = LoadHarness(srv, work()).run()
        peak = torch.cuda.max_memory_allocated() - base
        rc, out = obs_cli("slo", tmp, "--json")
    slo = json.loads(out)
    gen = sum(len(t) - len(rep.requests[r].prompt) for r, t in rep.results.items())
    if rc != 0 or slo["requests"]["finished"] != SERVE_LOAD["requests"] or rep.killed:
        raise AssertionError(f"serve: load run {slo['requests']}, obs slo exit {rc}")
    phase("serve", f"load run: {SERVE_LOAD['requests']} requests at {SERVE_LOAD['rate']}/s "
          f"(prompts 8-447 tokens, 16-63 new), {rep.boundaries} boundaries in "
          f"{rep.wall_s:.3f} s: {slo['requests']['finished'] / rep.wall_s:.2f} requests/s, "
          f"{gen / rep.wall_s:.1f} generated tokens/s; obs slo: TTFT p50 "
          f"{slo['ttft']['p50_ms']} ms p99 {slo['ttft']['p99_ms']} ms, TPOT p50 "
          f"{slo['tpot']['p50_ms']} ms p99 {slo['tpot']['p99_ms']} ms, e2e p99 "
          f"{slo['e2e']['p99_ms']} ms, goodput {slo['goodput']}, occupancy "
          f"{slo['occupancy']}; max submit lateness {rep.max_submit_lateness_s:.4f} s; "
          f"before the row blocks: TTFT p50 {old['ttft_p50_ms']} ms p99 "
          f"{old['ttft_p99_ms']} ms, {old['tokens_per_s']} generated tokens/s")
    phase("serve", f"peak device memory of the load run above what was allocated before "
          f"it {peak / 2**20:.1f} MiB (before it {base / 2**20:.1f} MiB); the KV cache "
          f"{kv_bytes / 2**20:.1f} MiB ({SERVE_BATCH} slots x {LM_LAYERS} layers x K,V x "
          f"{SERVE_MAX_LEN} x 768 x bf16); f32 params {4 * sum(t.numel() for t in tree_leaves(params)) / 2**20:.1f} MiB; "
          f"{card_line}")

    # one full segment of 16 ticks, 8 rows busy, timed and then profiled
    reqs = serve_requests()
    srv = Server(model, params, max_batch=SERVE_BATCH, segment=SERVE_SEGMENT,
                 device=SERVE_DEVICE)
    for p, _ in reqs:
        srv.submit(p, 4 * SERVE_SEGMENT)
    srv.step()  # admission and a first segment
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srv.step()
    torch.cuda.synchronize()
    tick_ms = 1e3 * (time.perf_counter() - t0) / SERVE_SEGMENT
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        srv.step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    busy_ms, _ = busy_union_ms(prof)
    launches = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    phase("serve", f"one segment ({SERVE_SEGMENT} ticks, {SERVE_BATCH} rows): "
          f"{tick_ms:.3f} ms a tick unprofiled; under the profiler {wall_ms / SERVE_SEGMENT:.3f} "
          f"ms a tick, {launches / SERVE_SEGMENT:.1f} kernel launches a tick, device busy "
          f"{busy_ms / SERVE_SEGMENT:.4f} ms a tick ({100 * busy_ms / wall_ms:.1f}% of the "
          f"wall); before the row blocks: {old['tick_ms']} ms and {old['launches']} "
          f"launches a tick; top kernels:")
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        phase("serve", f"  {e.self_device_time_total / 1e3 / SERVE_SEGMENT:9.4f} ms/tick "
              f"{e.count / SERVE_SEGMENT:6.1f} calls/tick  {e.key[:90]}")
    srv.drain()


def serve_path(card_line: str) -> dict:
    """ptb-transformer-large's model (seeded weights) served: greedy and
    sampled self-consistency, card vs CPU, the load run; returns the
    greedy server's results for the spec phase."""
    from mpit_tpu_torch.utils.params import tree_leaves

    model = serve_model()
    params = model.init(torch.Generator().manual_seed(SERVE_SEED))
    n = sum(t.numel() for t in tree_leaves(params))
    phase("serve", f"ptb-transformer-large's model: {LM_LAYERS} layers, d_model 768, 12 "
          f"heads, d_ff 3072, max_len {SERVE_MAX_LEN}, vocab {SERVE_VOCAB}, bf16 compute, "
          f"{n} parameters (seeded init {SERVE_SEED}); {card_line}")
    reqs = serve_requests()
    greedy = serve_consistency(model, params, reqs, {}, "greedy")
    serve_consistency(model, params, reqs, SERVE_SAMPLED, f"sampled {SERVE_SAMPLED}")
    serve_prefix_count(model, params, reqs)
    serve_vs_cpu(params, reqs[0][0])
    serve_load(model, params, card_line)
    return {"model": model, "params": params, "reqs": reqs, "greedy": greedy}


def serve_spec(card_line: str, served: dict) -> None:
    """The greedy requests through the speculative server with a 2-layer,
    d_model 256 draft (seeded): tokens against the greedy server's,
    acceptance, tokens per target read, tokens/s."""
    from mpit_tpu_torch.models import Server, serving
    from mpit_tpu_torch.models.transformer import TransformerLM

    model, params, reqs = served["model"], served["params"], served["reqs"]
    draft = TransformerLM(SERVE_VOCAB, num_layers=2, d_model=256, num_heads=4,
                          max_len=SERVE_MAX_LEN, device=SERVE_DEVICE)
    d_params = draft.init(torch.Generator().manual_seed(SERVE_SEED + 1))
    stats = {"row_rounds": 0, "emitted": 0}
    real = serving._serve_spec_segment

    def counting(tgt, dft, k, r_cap, t_params, d_params, t_cache, d_cache, prev, pos0,
                 rounds):
        out = real(tgt, dft, k, r_cap, t_params, d_params, t_cache, d_cache, prev, pos0,
                   rounds)
        busy = pos0 > 0  # free slots pass 0
        stats["row_rounds"] += rounds * int(busy.sum())
        stats["emitted"] += int(out[4][busy].sum())
        return out

    serving._serve_spec_segment = counting
    try:
        srv = Server(model, params, max_batch=SERVE_BATCH, draft_model=draft,
                     draft_params=d_params, spec_k=SPEC_K, device=SERVE_DEVICE)
        rids = [srv.submit(p, mn) for p, mn in reqs]
        t0 = time.perf_counter()
        got = srv.drain()
        wall = time.perf_counter() - t0
    finally:
        serving._serve_spec_segment = real
    diverged = []
    for i, rid in enumerate(rids):
        want = served["greedy"][i]
        j = first_divergence(want, got[rid])
        if j is not None:
            diverged.append((i, j - len(reqs[i][0]), divergence_gap(
                model, params, want, j, got[rid][j])))
    check_near_ties("serve-spec", diverged)
    per_read = stats["emitted"] / stats["row_rounds"]
    phase("serve-spec", f"draft: 2 layers, d_model 256, 4 heads, vocab {SERVE_VOCAB} "
          f"(seeded init {SERVE_SEED + 1}); spec_k {SPEC_K}: {SERVE_REQS - len(diverged)} of "
          f"{SERVE_REQS} requests equal the greedy serve run's; divergences (request, "
          f"generated token, gap): {diverged}; {per_read:.3f} tokens per target read "
          f"(acceptance {(per_read - 1) / SPEC_K:.4f}); "
          f"{SERVE_REQS * SERVE_NEW / wall:.1f} tokens/s ({wall:.3f} s); {card_line}")


def serve_rnn(card_line: str) -> None:
    """``RNNServer`` at ptb-lstm-easgd's widths over the load schedule
    without the length cap; every result against its solo generate_rnn."""
    from mpit_tpu_torch import random as jrandom
    from mpit_tpu_torch.loadgen import LoadHarness, LoadSpec, make_workload
    from mpit_tpu_torch.models import RNNServer, generate_rnn
    from mpit_tpu_torch.models.lstm import LSTMLM
    from mpit_tpu_torch.utils.params import tree_leaves

    lstm = LSTMLM(device=SERVE_DEVICE)
    params = lstm.init(torch.Generator().manual_seed(SERVE_SEED))
    n = sum(t.numel() for t in tree_leaves(params))
    if n != RNN_FLOATS:
        raise AssertionError(f"serve-rnn: {n} floats != {RNN_FLOATS}")
    work = make_workload(LoadSpec(**SERVE_LOAD), SERVE_VOCAB)
    warm = RNNServer(lstm, params, max_batch=SERVE_BATCH, segment=SERVE_SEGMENT,
                     device=SERVE_DEVICE)
    for r in work[:8]:
        warm.submit(list(r.prompt), r.max_new)
    warm.drain()
    rep = LoadHarness(RNNServer(lstm, params, max_batch=SERVE_BATCH,
                                segment=SERVE_SEGMENT, device=SERVE_DEVICE), work).run()
    gen = sum(len(t) - len(rep.requests[r].prompt) for r, t in rep.results.items())
    key = jrandom.key(0, SERVE_DEVICE)
    diverged = []
    for rid, req in rep.requests.items():
        solo = generate_rnn(lstm, params, list(req.prompt), req.max_new,
                            rng=jrandom.fold_in(key, rid), device=SERVE_DEVICE)
        j = first_divergence(solo, rep.results[rid])
        if j is not None:
            with torch.no_grad():
                logits = lstm.apply(params, torch.tensor([solo[:j]], device=SERVE_DEVICE))[0, -1]
            diverged.append((rid, j - len(req.prompt),
                             abs(float(logits[solo[j]] - logits[rep.results[rid][j]]))))
    check_near_ties("serve-rnn", diverged)
    phase("serve-rnn", f"RNNServer(max_batch={SERVE_BATCH}, segment={SERVE_SEGMENT}), "
          f"LSTM vocab {SERVE_VOCAB}, embed 256, hidden 512, 2 layers, bf16 ({n} floats, "
          f"seeded init {SERVE_SEED}), the load schedule without a length cap: "
          f"{len(rep.results)} requests in {rep.wall_s:.3f} s, {gen / rep.wall_s:.1f} "
          f"generated tokens/s; {len(rep.results) - len(diverged)} of {len(rep.results)} "
          f"equal their solo generate_rnn; divergences (request, generated token, gap): "
          f"{diverged}; {card_line}")


def generate_flash(served: dict) -> int:
    """The fixed-buffer ``generate`` on the serving model built with
    ``attn_impl="flash"``: 16 greedy tokens, one sm90 forward launch per
    layer per token (counts set to 0 just before, read just after), and
    the flash model's logits against the xla model's."""
    from mpit_tpu_torch.models import generate
    from mpit_tpu_torch.ops import flash_attention as fa

    params, prompt = served["params"], served["reqs"][0][0]
    flash, xla = serve_model(attn_impl="flash"), serve_model()
    for k in fa.launches:
        fa.launches[k] = 0
    t0 = time.perf_counter()
    toks = generate(flash, params, prompt, 16, device=SERVE_DEVICE)
    wall = time.perf_counter() - t0
    launched = dict(fa.launches)
    want = {k: 0 for k in launched}
    want["flash_forward_sm90"] = 16 * LM_LAYERS
    if launched != want:
        raise AssertionError(f"generate-flash: launches {launched} != {want}")
    buf = torch.zeros(1, SERVE_MAX_LEN, dtype=torch.long, device=SERVE_DEVICE)
    buf[0, :len(toks)] = torch.tensor(toks, device=SERVE_DEVICE)
    with torch.no_grad():
        a, b = flash.apply(params, buf)[0, :len(toks)], xla.apply(params, buf)[0, :len(toks)]
    err = (a - b).abs().max().item()
    torch.testing.assert_close(a, b, **SERVE_BF16_TOL)
    tol = FLASH_TOL[torch.bfloat16]
    past = int(((a - b).abs() > tol + tol * b.abs()).sum())
    same = toks == generate(xla, params, prompt, 16, device=SERVE_DEVICE)
    phase("generate-flash", f"generate (fixed (1, {SERVE_MAX_LEN}) buffer) on the flash "
          f"model, 16 greedy tokens in {wall:.3f} s: flash launches {json.dumps(launched)}; "
          f"logits vs the xla model's at the {len(toks)} filled positions: max |err| "
          f"{err:.4g} (rtol, atol {SERVE_BF16_TOL['atol']}); {past} of {a.numel()} past "
          f"FLASH_TOL[bf16] {tol}; tokens equal the xla model's: {same}")
    return launched["flash_forward_sm90"]


def conv_determinism() -> None:
    """ROADMAP C7: cuDNN's flags back at PyTorch's defaults, then a tiny
    ``run()``, which must set the deterministic algorithms; then the
    dp-quant phase's fused LeNet leg twice with no override here: the
    losses equal bit for bit. One leg with the defaults, for the cost."""
    import numpy as np

    from mpit_tpu_torch.data import load_mnist
    from mpit_tpu_torch.run import run
    from mpit_tpu_torch.utils.config import TrainConfig

    gb = DP_PER_WORKER * WORKERS
    x_tr, y_tr, *_ = load_mnist(synthetic_train=max(2048, gb))
    idx = np.random.default_rng(0).integers(0, len(x_tr), gb)
    x, y = (torch.as_tensor(a[idx]).cuda() for a in (x_tr, y_tr))
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, False
    free = dp_leg("fused", x, y)
    run(dataclasses.replace(TrainConfig().apply_preset("mnist-easgd"), algo="sync",
                            train_size=256, global_batch=64, epochs=1))
    if not torch.backends.cudnn.deterministic or torch.backends.cudnn.benchmark:
        raise AssertionError("conv-determinism: run() left cudnn.deterministic "
                             f"{torch.backends.cudnn.deterministic}, benchmark "
                             f"{torch.backends.cudnn.benchmark}")
    legs = [dp_leg("fused", x, y) for _ in range(2)]
    a, b = (leg["losses"] for leg in legs)
    if a != b:
        raise AssertionError(f"conv-determinism: losses differ: {a[-3:]} vs {b[-3:]}")
    phase("conv-determinism", f"after run(): cudnn.deterministic True, benchmark False; "
          f"the fused LeNet DP leg twice ({len(a)} steps): losses equal bit for bit "
          f"({a[0]:.6f} -> {a[-1]:.9g}); ms a step {legs[0]['ms_per_step']:.3f} and "
          f"{legs[1]['ms_per_step']:.3f} deterministic, {free['ms_per_step']:.3f} with "
          f"PyTorch's defaults (losses {free['losses'][0]:.6f} -> {free['losses'][-1]:.9g})")


# the fleet phase (ROADMAP A10b): scripts/fleet_soak.sh's run shape (16
# requests at 25/s, 3 replicas, refreshes at boundaries 20 and 60 in bf16,
# a kill of rank 1 at boundary 30 with a spare and the controller)
FLEET_REQUESTS, FLEET_RATE = 16, 25.0
FLEET_REPLICAS = 3
FLEET_KILL_AFTER, FLEET_KILL_RANK = 30, 1
FLEET_REFRESH = (20, 60)
FLEET_SLO_MS = 60_000.0  # the fleet CLI's --slo-ms default
# the kill leg's workload seed: its first request arrives at 11 ms with 15
# new tokens, and p2c at router seed 0 sends rid 0 to rank 1, so the kill at
# boundary 30 finds rank 1 holding work (at seed 0 the first request comes
# at 74 ms, after boundary 30 of an idle router)
FLEET_KILL_SEED = 3
FLEET_SOAK_SEED = 0  # fleet_soak.sh's first round
FLEET_SATURATE = 96  # requests arriving at once: threads against processes
FLEET_CLI_TIMEOUT_S = 240
REPO = os.path.dirname(os.path.abspath(__file__))


def fleet_work(seed: int, vocab: int = SERVE_VOCAB, max_len: int = SERVE_MAX_LEN,
               requests: int = FLEET_REQUESTS, rate: float = FLEET_RATE) -> list:
    """``make_workload(LoadSpec(requests, rate, seed), vocab, max_len)`` with
    the fleet CLI's SLO on every request."""
    from mpit_tpu_torch.loadgen import LoadSpec, make_workload

    work = make_workload(LoadSpec(requests=requests, rate=rate, seed=seed, cancel_prob=0.0),
                         vocab, max_len=max_len)
    for r in work:
        r.slo_ms = FLEET_SLO_MS
    return work


def journals(d: str) -> list:
    import glob

    return sorted(glob.glob(os.path.join(d, "obs_rank*.jsonl")))


def finish_window_rate(paths: list) -> float:
    """Generated tokens a second between the first and the last
    ``req_finish`` of the journals (the first finish's tokens left out):
    the serving rate with the start-up before the first reply taken away."""
    from mpit_tpu_torch.obs.merge import read_journal

    done = sorted((r["t"], r.get("gen", 0)) for p in paths for r in read_journal(p)
                  if r.get("ev") == "req_finish")
    return sum(g for _, g in done[1:]) / (done[-1][0] - done[0][0])


def fleet_thread_run(model, params, out: str, seed: int, work_seed: int, **kw) -> tuple:
    """One ``FleetHarness`` run of 3 replicas in threads, each a
    ``Server(max_batch=8, segment=16)`` of the serving model journaling into
    ``out/rep<rank>``, the router journal in ``out``; returns the workload,
    the report, the audit and the run's numbers."""
    from mpit_tpu_torch.fleet import FleetHarness, audit_lifecycle
    from mpit_tpu_torch.loadgen import aggregate_paths, pooled_latencies
    from mpit_tpu_torch.models import Server
    from mpit_tpu_torch.obs.core import ObsConfig

    def factory(rank):
        return Server(model, params, max_batch=SERVE_BATCH, segment=SERVE_SEGMENT,
                      device=SERVE_DEVICE, obs=ObsConfig(dir=os.path.join(out, f"rep{rank}")))

    work = fleet_work(work_seed)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rep = FleetHarness(factory, work, n_replicas=FLEET_REPLICAS, policy="p2c", seed=seed,
                       obs_dir=out, **kw).run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    audit = audit_lifecycle([out])
    e2e = aggregate_paths(journals(out))["e2e"]
    reps = sorted(d for d in os.listdir(out) if d.startswith("rep"))
    ttft = pooled_latencies([journals(os.path.join(out, d)) for d in reps],
                            names=("ttft",))["ttft"]
    gen = sum(len(rep.results[r.rid]["tokens"]) - len(r.prompt) for r in work)
    stats = dict(tokens_per_s=round(gen / rep.wall_s, 1), wall_s=round(rep.wall_s, 3),
                 e2e_p50_ms=e2e["p50_ms"], e2e_p99_ms=e2e["p99_ms"],
                 ttft_p50_ms=ttft["p50_ms"], ttft_p99_ms=ttft["p99_ms"],
                 redispatched=rep.redispatched, peak_mib=round(peak / 2**20, 1))
    return work, rep, audit, stats


def check_audit(leg: str, audit: dict) -> None:
    if not audit["ok"] or audit["lost"] or not audit["versions_monotonic"]:
        raise AssertionError(f"fleet {leg}: audit {audit}")


def fleet_kill_leg(model, params, tmp: str) -> None:
    """(a) greedy, no refresh: a clean run and a run with rank 1 killed at
    boundary 30 (a spare, the controller); every request's tokens equal
    across the two runs and equal its solo ``generate_fast``."""
    from mpit_tpu_torch.loadgen import ServeChaos
    from mpit_tpu_torch.models import generate_fast

    runs = {}
    for name, kw in (("clean", {}),
                     ("kill", dict(chaos=ServeChaos(seed=0, kill_after=FLEET_KILL_AFTER),
                                   kill_rank=FLEET_KILL_RANK, spares=1,
                                   use_controller=True))):
        runs[name] = fleet_thread_run(model, params, os.path.join(tmp, f"a-{name}"), 0,
                                      FLEET_KILL_SEED, **kw)
        check_audit(f"(a) {name}", runs[name][2])
    work, kill, audit, stats = runs["kill"]
    if audit["dead_replicas"] != [FLEET_KILL_RANK] or not kill.redispatched > 0:
        raise AssertionError(f"fleet (a): the kill orphaned nothing: dead "
                             f"{audit['dead_replicas']}, redispatched {kill.redispatched}")
    clean_work, clean = runs["clean"][0], runs["clean"][1]
    differ = []
    for a, b in zip(clean_work, work):
        solo = generate_fast(model, params, list(a.prompt), a.max_new, device=SERVE_DEVICE)
        if not clean.results[a.rid]["tokens"] == kill.results[b.rid]["tokens"] == solo:
            differ.append(a.rid)
    if differ:
        raise AssertionError(f"fleet (a): requests {differ} differ between the clean run, "
                             f"the kill run and their solo calls")
    for name, run in runs.items():
        phase("fleet", f"(a) {name}: {json.dumps(run[3])}; controller "
              f"{[(x.kind, x.rank, x.reason) for x in run[1].controller_log]}")
    phase("fleet", f"(a) {FLEET_REQUESTS} requests (workload seed {FLEET_KILL_SEED}), 3 "
          f"replicas in threads, p2c seed 0: both audits ok, lost []; the kill run's "
          f"dead replicas {audit['dead_replicas']}, {kill.redispatched} redispatched, spare "
          f"{kill.spawned_ranks} spawned; every request's tokens equal across the two runs "
          f"and equal its solo generate_fast")


def fleet_soak_pair(model, params, tmp: str) -> None:
    """(b) fleet_soak.sh's pair at full width: refreshes at boundaries 20 and
    60 in bf16, the chaos run with the kill, a spare and the controller;
    the audits, ``pin --expect-kill`` and ``obs slo --gate``; each push's
    bytes and its seconds to encode, send and install."""
    import contextlib
    import io

    from mpit_tpu_torch.fleet import StaticWeightSource, replica, weights
    from mpit_tpu_torch.fleet.__main__ import main as fleet_main
    from mpit_tpu_torch.loadgen import ServeChaos
    from mpit_tpu_torch.utils.params import tree_map

    pushes = []
    encode, publish, install = (weights.WeightPublisher._encode,
                                weights.WeightPublisher.publish_to,
                                replica.ReplicaServer._install)

    def timed_encode(self, p):
        t0 = time.perf_counter()
        out = encode(self, p)
        pushes.append({"bytes": sum(a.nbytes for a in out[1]),
                       "encode_s": time.perf_counter() - t0})
        return out

    def timed_publish(self, rank):
        t0 = time.perf_counter()
        out = publish(self, rank)
        rec = pushes[-1]
        rec["send_s"] = time.perf_counter() - t0 - rec["encode_s"]
        return out

    def timed_install(self, version, names, arrays):
        t0 = time.perf_counter()
        install(self, version, names, arrays)
        torch.cuda.synchronize()
        installs.append(time.perf_counter() - t0)

    def bump(version):
        return tree_map(lambda a: a + 1e-3 * version, params)

    dirs, report = {}, {}
    weights.WeightPublisher._encode = timed_encode
    weights.WeightPublisher.publish_to = timed_publish
    replica.ReplicaServer._install = timed_install
    try:
        for name, kw in (("clean", {}),
                         ("chaos", dict(chaos=ServeChaos(seed=FLEET_SOAK_SEED,
                                                         kill_after=FLEET_KILL_AFTER),
                                        kill_rank=FLEET_KILL_RANK, spares=1,
                                        use_controller=True))):
            pushes.clear()
            installs = []
            dirs[name] = os.path.join(tmp, f"b-{name}")
            _, rep, audit, stats = fleet_thread_run(
                model, params, dirs[name], FLEET_SOAK_SEED, FLEET_SOAK_SEED,
                source=StaticWeightSource(params, version=1), quant="bf16",
                refresh_boundaries=FLEET_REFRESH, refresh_params_fn=bump, **kw)
            check_audit(f"(b) {name}", audit)
            report[name] = (rep, audit, stats, list(pushes), installs)
    finally:
        weights.WeightPublisher._encode = encode
        weights.WeightPublisher.publish_to = publish
        replica.ReplicaServer._install = install
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fleet_main(["pin", dirs["clean"], dirs["chaos"], "--expect-kill"])
    pin = buf.getvalue().strip().splitlines()
    if rc != 0:
        raise AssertionError(f"fleet (b): pin --expect-kill exited {rc}: {pin}")
    rc, out = obs_cli("slo", dirs["chaos"], "--gate",
                      os.path.join(REPO, "scripts", "fleet_smoke.json"))
    if rc != 0:
        raise AssertionError(f"fleet (b): obs slo --gate fleet_smoke.json exited {rc}:\n{out}")
    for name, (rep, audit, stats, pushed, installs) in report.items():
        phase("fleet", f"(b) {name}: {json.dumps(stats)}; versions by replica "
              f"{audit['versions_by_replica']}; dead {audit['dead_replicas']}; pushed "
              f"{rep.weights_pushed}")
        phase("fleet", f"(b) {name}: {len(pushed)} pushes, bytes "
              f"{sorted({p['bytes'] for p in pushed})}; encode s "
              f"{[round(p['encode_s'], 4) for p in pushed]}; send s "
              f"{[round(p.get('send_s', 0.0), 6) for p in pushed]}; install s "
              f"{[round(t, 4) for t in installs]}")
    phase("fleet", f"(b) {pin[0]}; pin --expect-kill: {pin[-1]}; obs slo --gate "
          f"scripts/fleet_smoke.json on the chaos run: exit 0")


def fleet_cli(out: str, *flags) -> tuple[dict, float]:
    """``python -m mpit_tpu_torch.fleet run --out out *flags`` on the card
    (``SERVE_DEVICE``):
    its report line and wall seconds; fails on a non-zero exit."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "mpit_tpu_torch.fleet", "run", "--out", out,
                        "--replicas", str(FLEET_REPLICAS), "--requests", str(FLEET_REQUESTS),
                        "--rate", str(int(FLEET_RATE)), "--device", SERVE_DEVICE, *flags],
                       cwd=REPO, capture_output=True, text=True, timeout=FLEET_CLI_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"fleet run {' '.join(flags)} exited {r.returncode}:\n"
                             f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1]), wall


def fleet_procs(tmp: str) -> None:
    """(c) the CLI's own model: 3 replica processes, clean and with rank 1
    SIGKILLed at boundary 30, beside the same run in threads and one
    ``Server`` on the workload; then all three on a burst of requests
    arriving at once."""
    from mpit_tpu_torch.fleet import FleetHarness, audit_lifecycle
    from mpit_tpu_torch.fleet.__main__ import _build_model, _proc_harness
    from mpit_tpu_torch.loadgen import LoadHarness
    from mpit_tpu_torch.models import Server
    from mpit_tpu_torch.obs.core import ObsConfig

    rates = {}
    runs = {}
    for name, flags in (("procs", ["--procs"]),
                        ("procs-kill", ["--procs", "--kill-after", str(FLEET_KILL_AFTER),
                                        "--kill-rank", str(FLEET_KILL_RANK)]),
                        ("threads", [])):
        d = os.path.join(tmp, f"c-{name}")
        report, wall = fleet_cli(d, *flags)
        if not report["fleet"]["ok"]:
            raise AssertionError(f"fleet (c) {name}: {report['fleet']}")
        runs[name] = (d, report, wall)
        rates[name] = report["tokens"] / report["client"]["wall_s"]
    summaries = []
    for rank in range(1, FLEET_REPLICAS + 1):
        with open(os.path.join(runs["procs"][0], f"rep{rank}.out")) as f:
            summaries.append(json.loads(f.read().strip().splitlines()[-1]))
    pids = {s["pid"] for s in summaries}
    cuda = SERVE_DEVICE == "cuda"
    if (not all(s["device"] == SERVE_DEVICE and s["cuda_initialized"] == cuda
                for s in summaries)
            or len(pids) != FLEET_REPLICAS or os.getpid() in pids):
        raise AssertionError(f"fleet (c): replica summaries {summaries}")
    kill = runs["procs-kill"][1]
    with open(os.path.join(runs["procs-kill"][0], f"rep{FLEET_KILL_RANK}.out")) as f:
        corpse = f.read()
    if (kill["client"]["killed_ranks"] != [FLEET_KILL_RANK]
            or kill["client"]["dead_ranks"] != [FLEET_KILL_RANK] or corpse):
        raise AssertionError(f"fleet (c): kill not detected: {kill['client']}; rank "
                             f"{FLEET_KILL_RANK} printed {corpse!r}")
    model, params = _build_model(0, SERVE_DEVICE)
    work = fleet_work(0, 17, 64)
    one = LoadHarness(Server(model, params, max_batch=2, segment=4, device=SERVE_DEVICE),
                      work).run()
    rates["one Server"] = sum(len(t) - len(one.requests[r].prompt)
                              for r, t in one.results.items()) / one.wall_s
    for name, (d, report, wall) in runs.items():
        phase("fleet", f"(c) fleet run {name}: {report['tokens']} tokens, "
              f"{rates[name]:.1f} generated tokens/s over the router's wall "
              f"{report['client']['wall_s']} s (replica start-up included), e2e p50 "
              f"{report['e2e']['p50_ms']} ms p99 {report['e2e']['p99_ms']} ms, "
              f"{json.dumps(report['fleet'])}, client {json.dumps(report['client'])}; "
              f"command {wall:.3f} s")
    phase("fleet", f"(c) replica processes {[s['pid'] for s in summaries]} each on "
          f"{summaries[0]['device']} with its own CUDA context (this process "
          f"{os.getpid()}); the kill run's SIGKILL of rank {FLEET_KILL_RANK} detected "
          f"(dead ranks {kill['client']['dead_ranks']}, no exit summary), audit ok; "
          f"generated tokens/s at {FLEET_RATE:g}/s: processes {rates['procs']:.1f}, threads "
          f"{rates['threads']:.1f}, one Server {rates['one Server']:.1f}")

    # the burst: FLEET_SATURATE requests at once, the serving window's rate
    burst = {}
    env = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = REPO + ("" if env is None else os.pathsep + env)
    try:
        d = os.path.join(tmp, "c-burst-procs")
        work = fleet_work(1, 17, 64, FLEET_SATURATE, 1e6)
        _proc_harness(d, 2, 4, 0, device=SERVE_DEVICE, requests=work,
                      n_replicas=FLEET_REPLICAS, seed=0, obs_dir=d).run()
        check_audit("(c) burst procs", audit_lifecycle([d]))
        burst["processes"] = finish_window_rate(journals(d))
    finally:
        if env is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = env
    d = os.path.join(tmp, "c-burst-threads")
    FleetHarness(lambda rank: Server(model, params, max_batch=2, segment=4,
                                     device=SERVE_DEVICE),
                 fleet_work(1, 17, 64, FLEET_SATURATE, 1e6), n_replicas=FLEET_REPLICAS,
                 seed=0, obs_dir=d).run()
    check_audit("(c) burst threads", audit_lifecycle([d]))
    burst["threads"] = finish_window_rate(journals(d))
    d = os.path.join(tmp, "c-burst-one")
    srv = Server(model, params, max_batch=2, segment=4, device=SERVE_DEVICE,
                 obs=ObsConfig(dir=d))
    for r in fleet_work(1, 17, 64, FLEET_SATURATE, 1e6):
        srv.submit(list(r.prompt), r.max_new)
    srv.drain()
    srv.close()
    burst["one Server"] = finish_window_rate(journals(d))
    phase("fleet", f"(c) a burst of {FLEET_SATURATE} requests at once, generated tokens/s "
          f"between the first and the last reply: " + ", ".join(
              f"{k} {v:.1f}" for k, v in burst.items()))


def fleet_path(card_line: str, served: dict) -> None:
    """The serving fleet (ROADMAP A10b) over the serve phase's full-width
    model: the kill leg, the soak pair, the CLI as processes."""
    import tempfile

    phase("fleet", card_line)
    with tempfile.TemporaryDirectory(prefix="fleet-") as tmp:
        # first-call set-up (cuBLAS handles, allocator growth) outside the runs
        from mpit_tpu_torch.models import Server

        warm = Server(served["model"], served["params"], max_batch=SERVE_BATCH,
                      segment=SERVE_SEGMENT, device=SERVE_DEVICE)
        for r in fleet_work(FLEET_KILL_SEED):
            warm.submit(list(r.prompt), r.max_new)
        warm.drain()
        fleet_kill_leg(served["model"], served["params"], tmp)
        fleet_soak_pair(served["model"], served["params"], tmp)
        fleet_procs(tmp)


def timed(name: str, fn, *args):
    """Run one phase and print its seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    phase(name, f"{time.perf_counter() - t0:.3f} s")
    return out


def main() -> int:
    # one card: hide the others before CUDA starts
    os.environ["CUDA_VISIBLE_DEVICES"] = one_card(os.environ)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import mpit_tpu_torch  # noqa: F401  (fails alone, without the repository)

    card_line = card()
    timed("build", build)
    timed("wire", wire_phase)
    timed("native", native_phase)
    kernel = timed("kernels", kernels_vs_plain)
    flash = timed("flash", flash_vs_plain)
    timed("round", round_vs_cpu)
    step_launches = timed("step", step_vs_cpu)
    kernel.update(timed("main", main_path, kernel["ms"]))
    timed("profile", profile_rounds)
    timed("ps-parity", ps_parity)
    timed("ps", ps_path, card_line)
    timed("ps-chaos", ps_chaos, card_line)
    ps_off = timed("ps-proc", ps_proc, card_line)
    timed("obs-ps", obs_ps, card_line, ps_off)
    timed("rt", rt_path, card_line)
    for name in BASELINE:
        kernel["launches"] += timed(name, baseline_path, name, card_line)
    timed("dp-quant", dp_quant_path, card_line)
    lm_launches, lm_losses = timed("lm", lm_path, flash)
    for name in flash:
        # the bf16 LM runs the sm90 kernels; the CUDA-core ones run on the
        # f32 path, whose launches the step phase counted
        path = lm_launches if name.endswith("_sm90") else step_launches
        flash[name]["launches"] = path[name]
    timed("lm-profile", profile_lm)
    traced = timed("obs-lm", obs_lm, card_line)
    for name in flash:
        if name.endswith("_sm90"):
            flash[name]["launches"] += traced[name]
    zero = timed("zero", zero_path, card_line, lm_losses)
    for name in flash:
        if name.endswith("_sm90"):
            flash[name]["launches"] += zero[name]
    timed("seq", seq_path, card_line)
    remat = timed("remat", remat_path, card_line)
    for name in flash:
        if name.endswith("_sm90"):
            flash[name]["launches"] += remat[name]
    kernel["launches"] += timed("resume-easgd", resume_easgd)["launches"]
    resumed = timed("resume-lm", resume_lm, card_line)
    for name in flash:
        if name.endswith("_sm90"):
            flash[name]["launches"] += resumed[name]
    timed("ps-resume", ps_resume)
    timed("profile-dir", profile_phase)
    timed("dist", dist_phase)
    served = timed("serve", serve_path, card_line)
    timed("serve-spec", serve_spec, card_line, served)
    timed("serve-rnn", serve_rnn, card_line)
    timed("fleet", fleet_path, card_line, served)
    flash["flash_forward_sm90"]["launches"] += timed("generate-flash", generate_flash, served)
    timed("conv-determinism", conv_determinism)
    order = ["name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    rows = [kernel, *flash.values()]
    print(json.dumps({"kernels": [{k: r[k] for k in order} for r in rows]}))
    print(json.dumps(device_line(torch.cuda.get_device_name(0),
                                 torch.cuda.device_count())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
