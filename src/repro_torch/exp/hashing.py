"""Content hashing for experiment-cell results (DESIGN.md §13).  Port
of ``repro.exp.hashing``.

A cell's cached result is keyed by ``sha256(cell spec JSON + source
tree digest)``: re-running an unchanged cell on an unchanged source
tree is a cache hit, and *any* edit to the cell definition or to the
port's git-tracked sources invalidates every affected cell.  The source
digest hashes file *contents* (not git index blobs), so unstaged edits
invalidate too; outside a git checkout it falls back to globbing the
same directories.
"""
from __future__ import annotations

import functools
import hashlib
import json
import subprocess
from pathlib import Path

# the source inputs a port cell result depends on: the port's tree (its
# engine, kernels and matrix) and the repo-root baselines the guards
# read.  The reference's tree is left out: editing it cannot change a
# row the port computes.
SOURCE_PATHS = ("src/repro_torch",)
BASELINE_FILES = ("BENCH_engine.json", "BENCH_fabric.json")


def repo_root() -> Path:
    return Path(__file__).resolve().parents[3]


def _tracked_files(root: Path) -> list[Path]:
    # --others --exclude-standard also lists untracked-but-not-ignored
    # sources: a brand-new module must invalidate the cache before its
    # first `git add`, or stale results would pass guards silently
    try:
        out = subprocess.run(
            ["git", "ls-files", "--cached", "--others", "--exclude-standard",
             "--", *SOURCE_PATHS, *BASELINE_FILES],
            cwd=root, capture_output=True, text=True, timeout=30)
        if out.returncode == 0 and out.stdout.strip():
            return [root / line for line in out.stdout.splitlines()]
    except (OSError, subprocess.SubprocessError):
        pass
    files: list[Path] = []
    for rel in SOURCE_PATHS:
        files += sorted(p for p in (root / rel).rglob("*")
                        if p.suffix in (".py", ".cu", ".cuh", ".json"))
    files += [root / f for f in BASELINE_FILES]
    return files


@functools.lru_cache(maxsize=1)
def tree_digest(root: Path | None = None) -> str:
    """One digest over every git-tracked source input (path + bytes)."""
    root = root or repo_root()
    h = hashlib.sha256()
    for path in sorted(_tracked_files(root)):
        if not path.is_file():
            continue
        h.update(str(path.relative_to(root)).encode())
        h.update(b"\0")
        h.update(path.read_bytes())
        h.update(b"\0")
    return h.hexdigest()


def cell_hash(cell, root: Path | None = None) -> str:
    """Content hash of a cell: canonical spec JSON + source tree digest."""
    payload = json.dumps(cell.to_json(), sort_keys=True,
                         separators=(",", ":"))
    h = hashlib.sha256()
    h.update(payload.encode())
    h.update(tree_digest(root).encode())
    return h.hexdigest()
