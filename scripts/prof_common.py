"""Helpers of the port's profiling scripts (``prof_torch_ms.py``,
``prof_torch_generic.py``, ``prof_torch_ipm.py``): the card's name and power limit, host-clock
medians of synchronized calls, and a torch.profiler summary of one call.
Needs CUDA; imports nothing of JAX."""

import statistics
import subprocess
import time


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def timed(torch, fn, reps):
    """Median host milliseconds of fn(), synchronized, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def profile_call(torch, fn, card_name, what="cold solve", top=10):
    """Trace one synchronized fn() with torch.profiler and print its wall
    time, the summed device-kernel time and launches, the device-busy share
    (kernel time over wall time, profiler on) and the ``top`` kernels by
    device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_total = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    by_name = {}
    for e in kern:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    print(f"profiled {what}: wall {wall:.2f} ms, device kernels "
          f"{dev_total:.2f} ms in {len(kern)} launches -> device busy "
          f"{100 * dev_total / wall:.1f}% (profiler on) on {card_name}")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {t:8.3f} ms  x{c:<5d} {name[:90]}")
