#!/usr/bin/env python3
"""Where chip_smoke.py's time goes: runs its `main()` while a thread
samples the main thread's chip_smoke frames every PERIOD seconds.

    python3 chip_smoke_sampler.py [OUT.json]   # from the repository root

OUT.json (default chiprun_out/smoke_samples.json) holds the wall time and
the sample counts (times PERIOD: seconds) by call path, from `main`'s
line down three chip_smoke functions, and by the innermost chip_smoke
line. The smoke's own output and exit code are unchanged.
"""
from __future__ import annotations

import atexit
import collections
import json
import os
import sys
import threading
import time

PERIOD = 0.25


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        "chiprun_out", "smoke_samples.json")
    by_path, by_line = collections.Counter(), collections.Counter()
    main_id = threading.main_thread().ident
    t0 = time.time()

    def sample():
        while True:
            frame = sys._current_frames().get(main_id)
            chain = []
            while frame is not None:
                if frame.f_code.co_filename.endswith("chip_smoke.py"):
                    chain.append((frame.f_code.co_name, frame.f_lineno))
                frame = frame.f_back
            chain.reverse()
            if chain:
                by_path[" > ".join(
                    [f"{n}:{line}" if i == 0 else n
                     for i, (n, line) in enumerate(chain[:4])])] += 1
                by_line["{}:{}".format(*chain[-1])] += 1
            time.sleep(PERIOD)

    def dump():
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as fh:
            json.dump(dict(period_s=PERIOD, wall_s=time.time() - t0,
                           by_path=by_path.most_common(400),
                           by_line=by_line.most_common(200)), fh, indent=0)

    atexit.register(dump)
    threading.Thread(target=sample, daemon=True).start()
    return chip_smoke.main()


if __name__ == "__main__":
    sys.exit(main())
