"""Where a short ``run()`` spends its time, unit by unit, on one card:
BASELINE's four configurations (``cifar-vgg-sync``, ``resnet50-sync``,
``ptb-lstm-easgd``, ``alexnet-downpour``) and the ``moe`` phase's moe-sync
LM, each at the size ``chip_smoke.py`` runs it::

    python3 unit_times.py [ROOT] [--label NAME]

It imports the port and ``chip_smoke.py`` from ROOT (default: this file's
directory), so that two checkouts compare in one call: run it once from
each, alternating (parent, change, change, parent). For each
configuration, with TF32 off as ``chip_smoke.py`` has it by then: a warm-up
``run()``; a ``run()`` as ``chip_smoke.py`` times it (ms a unit of its
wall); then one that synchronises after every unit: ms of unit 1 (eager),
of unit 2 (the capture and its first replay, where the trainer captures)
and the mean of the rest, the ms spent in ``UnitGraph._capture``, the
caching allocator's ``cudaMalloc`` and ``cudaFree`` calls and retries in
units 1, 2 and the rest, the ms the collector spent in each (by
generation; also before the first unit and after the last), its full
collections, the objects it tracks and the card's free memory before the
run. Then the f32 card-vs-CPU unit of ``cifar-vgg-sync`` (``chip_smoke.baseline_checks``)
with cuDNN's TF32 on, as it is by default: what it printed or raised.
Prints one JSON line a configuration, then the card's name and power
limit. Needs the card.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time


def measure(cfg, label: str, device=None) -> dict:
    """Three ``run()`` of ``cfg`` (warm-up, as timed, synchronised after
    each unit) and the breakdown of the last."""
    import torch

    import mpit_tpu_torch.run as run_mod
    from mpit_tpu_torch.parallel import capture as cap

    cuda = device is None or torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    marks, captures, allocs, collecting = [], [], [], []
    build_trainer, capture_body = run_mod.build_trainer, cap.UnitGraph._capture

    def allocator() -> tuple:
        stats = torch.cuda.memory_stats() if cuda else {}
        return tuple(stats.get(k, 0) for k in (
            "num_device_alloc", "num_device_free", "num_alloc_retries"))

    def mark():
        sync()
        marks.append(time.perf_counter())
        allocs.append(allocator())

    def on_collect(phase, info):
        # (unit it fell in, generation, start or stop time)
        collecting.append((len(marks), info["generation"], phase, time.perf_counter()))

    def timed_build(*args, **kwargs):
        trainer = build_trainer(*args, **kwargs)
        fit = trainer.fit

        def timed_fit(batches, state, **kw):
            key = "on_step" if "on_step" in kw else "on_round"
            inner = kw[key]

            def on_unit(done, st, m):
                inner(done, st, m)
                mark()

            kw[key] = on_unit
            mark()
            return fit(batches, state, **kw)

        trainer.fit = timed_fit
        return trainer

    def timed_capture(self, body):
        sync()
        t0 = time.perf_counter()
        capture_body(self, body)
        sync()
        captures.append(1e3 * (time.perf_counter() - t0))

    run_mod.run(cfg, device)  # warm-up
    cap.replays = 0
    res = run_mod.run(cfg, device)
    replays = cap.replays
    units = res["trained_units"]
    full = gc.get_stats()[2]["collections"]
    free_mib = torch.cuda.mem_get_info()[0] / 2**20 if cuda else None
    run_mod.build_trainer, cap.UnitGraph._capture = timed_build, timed_capture
    gc.callbacks.append(on_collect)
    try:
        run_mod.run(cfg, device)
    finally:
        gc.callbacks.remove(on_collect)
        run_mod.build_trainer, cap.UnitGraph._capture = build_trainer, capture_body
    ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    rest = ms[2:]
    # units 1, 2 and the rest, by the marks that close them
    spans = {"unit1": (0, 1), "unit2": (1, 2), "rest": (2, len(marks) - 1)}
    calls = {name: [b - a for a, b in zip(allocs[i], allocs[j])] if j > i else None
             for name, (i, j) in spans.items()}
    gc_ms = {}
    for (unit, gen, phase, t), (_, _, _, t_end) in zip(collecting[::2], collecting[1::2]):
        name = ("before" if unit == 0 else "unit1" if unit == 1 else "unit2" if unit == 2
                else "rest" if unit < len(marks) else "after")
        at = gc_ms.setdefault(name, {})
        at[gen] = at.get(gen, 0.0) + 1e3 * (t_end - t)
    return dict(
        config=label, units=units, replays=replays,
        run_ms_per_unit=1e3 * res["wall_s"] / units,
        unit1_ms=ms[0], unit2_ms=ms[1] if len(ms) > 1 else None,
        rest_ms=sum(rest) / len(rest) if rest else None,
        capture_ms=captures, malloc_free_retries=calls, gc_ms_by_generation=gc_ms,
        full_collections=gc.get_stats()[2]["collections"] - full,
        tracked_objects=len(gc.get_objects()), free_mib_before=free_mib)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", nargs="?", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("unit_times: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    import mpit_tpu_torch
    from mpit_tpu_torch.utils.config import TrainConfig

    for mod in (cs, mpit_tpu_torch):
        if not os.path.abspath(mod.__file__).startswith(root + os.sep):
            raise SystemExit(f"unit_times: {mod.__file__} is not under {root}")
    card_line = cs.card()
    cs.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    configs = [(name, TrainConfig().apply_preset(want["preset"]))
               for name, want in cs.BASELINE.items()]
    configs.append(("moe", cs.moe_config()))
    for name, cfg in configs:
        row = measure(cfg, name)
        print(json.dumps({"tree": args.label, **row}), flush=True)
    torch.backends.cudnn.allow_tf32 = True
    try:
        cs.baseline_checks("vgg")
        tf32 = "passed"
    except AssertionError as e:
        tf32 = f"raised: {e}"
    print(json.dumps({"tree": args.label, "vgg_unit_vs_cpu_cudnn_tf32_on": tf32}))
    print(card_line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
