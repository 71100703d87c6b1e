#!/usr/bin/env python3
"""How many device events torch.profiler loses at the start of its window,
as a process ages, on one NVIDIA GPU.

    python3 chip_profile_probe.py [SECONDS]     # default 420

Every ~8 s (matmuls keep the card busy in between) it profiles one small
call of 42 kernels (sin, 20 x relu and add, cos) three ways: alone, and
after a primer of 64 or of 256 throwaway kernels (int16 neg, synchronized,
after a 20 ms sleep) followed by 64 or 256 trailing ones (abs). Each line
is a JSON object: the process's age in seconds and, for each way, how
many primer (`lead`), measured (`call`) and trailing (`trail`) kernels
the profile holds, and whether it holds the call's first (`sin`) and
last (`cos`) kernel. chip_smoke.py's `device_profile` primes its profiles
after what this shows.
"""
from __future__ import annotations

import json
import sys
import time


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("chip_profile_probe: no CUDA device", file=sys.stderr)
        return 2
    duration = float(sys.argv[1]) if len(sys.argv) > 1 else 420.0
    busy_s = 8.0
    a = torch.randn(2048, 2048, device="cuda")
    s = torch.randn(4096, device="cuda")
    buf = torch.zeros(64, dtype=torch.int16, device="cuda")

    def call():
        x = torch.sin(s)
        for _ in range(20):
            x = torch.relu(x) + 1.0
        return torch.cos(x)

    def one(n, pad):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(n):
                torch.neg(buf)
            torch.cuda.synchronize()
            call()
            torch.cuda.synchronize()
            for _ in range(n):
                torch.abs(buf)
            torch.cuda.synchronize()
        names = [e.name().lower() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == torch.autograd.DeviceType.CUDA]
        lead = sum("neg" in k for k in names)
        trail = sum("abs" in k for k in names)
        return dict(lead=lead, call=len(names) - lead - trail, trail=trail,
                    sin=any("sin" in k for k in names),
                    cos=any("cos" in k for k in names))

    t0 = time.time()
    call()
    one(4, 0.0)
    torch.cuda.synchronize()
    while time.time() - t0 < duration:
        end = time.time() + busy_s
        while time.time() < end:
            for _ in range(50):
                a @ a
            torch.cuda.synchronize()
        print(json.dumps(dict(age_s=round(time.time() - t0, 1),
                              none=one(0, 0.0), p64=one(64, 0.02),
                              p256=one(256, 0.02))), flush=True)
    print(json.dumps(dict(torch=torch.__version__,
                          card=torch.cuda.get_device_name(0))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
