"""Does torch.profiler keep its CUDA records through a long process?

Runs ``chip_smoke.py``'s phases in one process, the phase "multi-GPU"
before "fixpoint engines and setups", and after each phase (and around
each part of "multi-GPU") opens three profiler sessions of 5 elementwise
launches and one of 2,000, printing how many CUDA records each held.
The first time a 5-launch session holds none, and at the end, the same
5-launch session runs in a fresh process for comparison.  A phase that
fails is reported and the probe goes on.

    python scripts/profiler_probe.py [LOG]

needs a CUDA card and the repository's kernels (built by the first
phase), and takes about as long as ``chip_smoke.py``; each line is also
appended to LOG when given.
"""

import os
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

SESSION = r'''
import torch
x = torch.ones(1 << 20, device="cuda")
acts = [torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]
with torch.profiler.profile(activities=acts) as prof:
    for _ in range(5):
        x.add_(1)
    torch.cuda.synchronize()
print(sum(1 for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA))
'''

LOG = sys.argv[1] if __name__ == "__main__" and len(sys.argv) > 1 else None
_fresh_done = []


def say(msg: str) -> None:
    print(msg, flush=True)
    if LOG:
        with open(LOG, "a") as f:
            f.write(msg + "\n")


def session(launches: int) -> int:
    """CUDA records of one profiler session of ``launches`` launches."""
    x = torch.ones(1 << 20, device="cuda")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(launches):
            x.add_(1)
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def probe(tag: str, fresh: bool = False) -> None:
    counts = [session(5) for _ in range(3)] + [session(2000)]
    line = (f"PROBE {tag}: sessions {counts}; profiler enabled before "
            f"{torch._C._autograd._profiler_enabled()}; threads "
            f"{sorted(t.name for t in threading.enumerate())}")
    if fresh or (min(counts[:3]) == 0 and not _fresh_done):
        _fresh_done.append(True)
        r = subprocess.run([sys.executable, "-c", SESSION],
                           capture_output=True, text=True)
        line += f"; fresh process {r.stdout.strip()} (rc {r.returncode})"
    say(line)


def main() -> int:
    if not torch.cuda.is_available():
        print("a CUDA card is needed", file=sys.stderr)
        return 1
    say(f"torch {torch.__version__} cuda {torch.version.cuda}")
    kernels = cs.chip_kernels()
    rows = {name: {"name": name, "route": "cuda", "source": "",
                   "replaces": k.replaces, "library_ms": None}
            for name, k in [(k.name, k) for k in kernels[:14]]
            + [(cs.wide_row(k, topo, t_len), k)
               for k, topo, t_len in cs.wide_rows()]}
    t_all = time.perf_counter()

    def phase(what, fn, *args):
        t0 = time.perf_counter()
        out = None
        try:
            out = fn(*args)
            say(f"phase {what}: {time.perf_counter() - t0:.1f} s ok")
        except Exception as e:
            say(f"phase {what}: FAILED {type(e).__name__}: {str(e)[:400]}")
        probe(f"after {what}")
        return out

    phase("build", cs.build_kernels)
    probe("start", fresh=True)
    phase("weightwise kernels", cs.check_kernels, torch, rows)
    phase("variant kernels", cs.check_variant_kernels, torch, rows)
    phase("kernels off the default builds", cs.check_wide_kernels, torch,
          rows)
    launches = phase("main path", cs.main_path, torch, kernels)
    phase("compact phases", cs.compact_path, torch, kernels, launches)
    phase("trajectory capture", cs.capture_path, torch, kernels, launches)
    phase("device telemetry", cs.telemetry_path, torch, kernels, launches)
    mega_runs = []
    phase("mega runs", cs.mega_path, torch, kernels, launches, mega_runs)
    phase("analysis tier", cs.analysis_path, torch, kernels, launches,
          mega_runs)
    phase("experiment service", cs.serve_path, torch, kernels, launches)

    world, launcher = cs.multigpu_world, cs.multigpu_launcher

    def probed_world(*args, **kw):
        probe(f"multi-GPU before world {args[1]} {args[2]}")
        out = world(*args, **kw)
        probe(f"multi-GPU after world {args[1]} {args[2]}")
        return out

    def probed_launcher(*args, **kw):
        out = launcher(*args, **kw)
        probe("multi-GPU after the launcher", fresh=True)
        return out

    cs.multigpu_world, cs.multigpu_launcher = probed_world, probed_launcher
    phase("multi-GPU", cs.multigpu_path, torch, kernels, launches)
    phase("fixpoint engines and setups", cs.engines_and_setups, torch,
          kernels, launches)
    phase("small soups vs cpu", cs.small_soup_vs_cpu, torch, kernels)
    probe("end", fresh=True)
    say(f"total {time.perf_counter() - t_all:.1f} s")
    return 0


if __name__ == "__main__":
    if LOG:
        open(LOG, "w").close()
    sys.exit(main())
