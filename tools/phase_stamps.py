"""What the phase tools share: a kernel source copied with clock stamps,
built with nvcc and loaded, and a record buffer the stamped kernel writes.

A stamped copy gets a ``__device__ long long* phase_prof`` and an
``extern "C" int <entry>_set_prof(void*)`` that points it at a device
buffer; its C launch signature stays the one ``runtime.SIGNATURES``
declares.  A kernel marks the places a tool stamps with lines of the form
``// PHASE(name)`` (``stamp``, ``cut``).
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path


def marker(name: str) -> re.Pattern:
    """The ``// PHASE(name)`` line, its indent captured."""
    return re.compile(rf"^([ \t]*)// PHASE\({re.escape(name)}\)[ \t]*\n",
                      re.MULTILINE)


def find(src: str, name: str) -> re.Match:
    """The one ``// PHASE(name)`` line of ``src``; exits if there is none
    or more than one."""
    found = list(marker(name).finditer(src))
    if len(found) != 1:
        sys.exit(f"phase_stamps: {len(found)} '// PHASE({name})' lines in "
                 f"the kernel, not 1")
    return found[0]


def stamp(src: str, names: list, extra: dict) -> str:
    """Each ``// PHASE(names[i])`` line replaced by ``const long long ci =
    clock64();`` and then ``extra.get(name)`` (C lines at its indent)."""
    for i, name in enumerate(names):
        m = find(src, name)
        indent = m.group(1)
        lines = [f"const long long c{i} = clock64();",
                 *extra.get(name, "").splitlines()]
        text = "".join(f"{indent}{line}\n" for line in lines)
        src = src[:m.start()] + text + src[m.end():]
    return src


def cut(src: str, first: str, last: str) -> str:
    """``src`` without the lines from ``// PHASE(first)`` up to (not with)
    ``// PHASE(last)``; both markers must be at one nesting level."""
    a, b = find(src, first), find(src, last)
    if b.start() <= a.start():
        sys.exit(f"phase_stamps: PHASE({last}) is not after PHASE({first})")
    return src[:a.start()] + src[b.start():]


def with_record_pointer(src: str, entry: str) -> str:
    """``src`` with the ``phase_prof`` pointer in its anonymous namespace
    and ``<entry>_set_prof`` after it."""
    src = src.replace("namespace {\n", "namespace {\n\n__device__ long long* "
                      "phase_prof;\n", 1)
    return src + (f'\nextern "C" int {entry}_set_prof(void* p) {{\n'
                  "  return static_cast<int>(cudaMemcpyToSymbol(\n"
                  "      phase_prof, &p, sizeof(p)));\n}\n")


def build(runtime, out: Path, name: str, src: str, kernel: str,
          tool: str):
    """``src`` written to ``out/<name>.cu``, built into ``out/<name>.so``
    and loaded, with ``<kernel>_launch`` declared as ``runtime`` declares
    it (and ``<kernel>_set_prof`` where the source has it)."""
    cu = out / f"{name}.cu"
    cu.write_text(src)
    lib_path = out / f"{name}.so"
    done = subprocess.run([runtime.nvcc(), *runtime.NVCC_FLAGS, "-o",
                           str(lib_path), str(cu)], capture_output=True,
                          text=True)
    if done.returncode != 0:
        sys.exit(f"{tool}: nvcc failed\n{done.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    launch = getattr(lib, f"{kernel}_launch")
    launch.argtypes = list(runtime.SIGNATURES[kernel])
    launch.restype = ctypes.c_int
    if f"{kernel}_set_prof" in src:
        getattr(lib, f"{kernel}_set_prof").argtypes = [ctypes.c_void_p]
    return lib


def set_records(lib, kernel: str, buffer, tool: str) -> None:
    """Points the stamped copy's ``phase_prof`` at ``buffer`` (a device
    tensor of int64)."""
    if getattr(lib, f"{kernel}_set_prof")(buffer.data_ptr()) != 0:
        sys.exit(f"{tool}: could not set the record buffer")
