"""Helpers of the kernel check scripts (``scripts/*_kernel_check.py``,
``bwd_ablate.py``, ``fwd_gate_check.py``): build a kernel's library from a
patched copy of the sources, print its ptxas report, and time launches on
one GPU with CUDA events or ``torch.profiler``.

Copies are built into the port's ignored build directory."""

import ctypes
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from diffudf_tpu_torch.native.build import BUILD_DIR  # noqa: E402
from diffudf_tpu_torch.ops import kernel_io as kio  # noqa: E402

# csrc/siren_fwd.cuh's Product, in the order of its template argument
PRODUCTS = ("kFp32", "kTf32x3", "kBf16")


def build(tag, csrc, main, patches=(), cmd=None):
    """The library of ``csrc/main`` built from copies of every source in
    ``csrc``, each patch applied where its text is, by ``cmd`` (by default
    this tree's command for ``main``); -> (the CDLL, its path)."""
    src_dir = os.path.join(BUILD_DIR, "check", tag)
    shutil.rmtree(src_dir, ignore_errors=True)
    shutil.copytree(csrc, src_dir)
    for old, new in patches:
        hits = 0
        for name in os.listdir(src_dir):
            path = os.path.join(src_dir, name)
            with open(path) as fh:
                text = fh.read()
            if old in text:
                hits += 1
                with open(path, "w") as fh:
                    fh.write(text.replace(old, new))
        if not hits:
            raise RuntimeError(f"{tag}: no source holds {old[:60]!r}")
    cmd = list(cmd or kio.nvcc_command(main))
    cmd[cmd.index(kio.CSRC)] = src_dir
    out = os.path.join(src_dir, main.replace(".cu", ".so"))
    proc = subprocess.run(cmd + ["-o", out, os.path.join(src_dir, main)], capture_output=True,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"{tag}: build failed\n{proc.stderr}")
    with open(out[:-3] + ".log", "w") as fh:
        fh.write(proc.stdout + proc.stderr)
    return ctypes.CDLL(out), out


def ptxas_report(lib):
    """Print the kernels and register lines of a library's build log (the
    ``.log`` beside the ``.so``), template arguments named."""
    with open(lib[:-3] + ".log") as fh:
        for line in fh:
            entry = re.search(r"entry function '.*?\d([a-z_]+_kernel)"
                              r"(ILi(\d+)ELi(\d+)E(LN\w*?ProductE(\d))?)?", line)
            if entry:
                args = f"<{entry.group(3)}, {entry.group(4)}" if entry.group(2) else ""
                if entry.group(6):
                    args += f", {PRODUCTS[int(entry.group(6))]}"
                print(f"  {entry.group(1)}{args}{'>' if args else ''}")
            elif "registers" in line or "spill" in line:
                print(f"    {line.strip()}")


def cuda_ms(fn, reps=10):
    """Median ms of ``reps`` calls of fn, each between two CUDA events,
    after one call to warm up."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernel_times(fn, reps=5):
    """{kernel name: mean device microseconds} of the port's kernels (those
    in namespace ``dudf`` or an anonymous one) over ``reps`` calls of fn."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {ev.key.replace("(anonymous namespace)::", "").split("(")[0].split("::")[-1][:40]:
            ev.device_time_total / ev.count
            for ev in prof.key_averages()
            if ev.device_time_total > 0 and ("dudf::" in ev.key or "anonymous" in ev.key)}
