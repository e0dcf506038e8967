#!/usr/bin/env python3
"""Where a training step's card time goes, for training phases of
``chip_smoke.py``: O (MultiDAE) and P (MultiVAE) on ``UserDataset``, and R
(DeepFM at criteo-1m-shape, batch 8192).

Run from the root of a checkout, on a machine with the card::

    python3 scripts/torch_step_profile.py [O] [P] [R]   # all when none is named

Each phase's model is built as ``chip_smoke.py`` builds it (O, P: the
synthetic ml-1m shape, seed 7; R: ``chip_smoke.criteo_setup``; the repo's
configs), takes 3 warm-up steps, then ``STEPS`` steps under
``torch.profiler``. It prints one JSON line a phase: the host time of a
step, the card's busy time a step (the union of its kernel and copy
intervals), its kernel launches a step, and the operators that hold the
card longest (self device time a step, with their calls a step).
"""
from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 10
PHASES = {"O": ("MultiDAE", 256), "P": ("MultiVAE", 500), "R": ("DeepFM", 8192)}


def phase_model(tag: str, device):
    """(model ready for steps, an endless stream of its device batches)."""
    import chip_smoke as c
    model_name, batch_size = PHASES[tag]
    if tag != "R":
        model = c.training_model(device, model_name, batch_size)[0]
        return model, c.epoch_stream(model)
    _, _, (trn, _, _), cls, conf, _, _ = c.criteo_setup()
    model = cls(conf, device=device)
    model._init_model(trn)
    model._init_parameter(trn)
    model.optimizer = model._get_optimizer()
    model._setup_scan_epoch(trn)
    return model, c.epoch_stream(model)


def profile_phase(tag: str, top: int = 15) -> dict:
    import torch
    from torch.autograd import DeviceType
    device = torch.device("cuda", 0)
    model_name, batch_size = PHASES[tag]
    model, batches = phase_model(tag, device)
    model.net.train()
    for _ in range(3):
        model._grad_step(next(batches))
    steps = [next(batches) for _ in range(STEPS)]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for batch in steps:
            model._grad_step(batch)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t) * 1e3
    model.net.eval()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy, end = busy + (b - a), b
        elif b > end:
            busy, end = busy + (b - end), b
    ops = sorted((e for e in prof.key_averages() if e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    return {"phase": tag, "model": model_name, "batch": batch_size,
            "history_width": getattr(model, "history_width", None), "steps": STEPS,
            "host_ms_per_step": host_ms / STEPS, "busy_ms_per_step": busy / 1e3 / STEPS,
            "device_events_per_step": len(events) / STEPS,
            "top_ops": [{"op": e.key, "device_ms_per_step": e.self_device_time_total / 1e3 / STEPS,
                         "calls_per_step": e.count / STEPS} for e in ops[:top]]}


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke
    print(f"GPU {chip_smoke.gpu_line()}", flush=True)
    for tag in sys.argv[1:] or sorted(PHASES):
        print(json.dumps(profile_phase(tag)), flush=True)
