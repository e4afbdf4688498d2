"""Run utilities."""

from __future__ import annotations

import os
import shutil


def backup_source_code(backup_dir: str):
    """Copy the port's package into the run directory, without its build
    outputs (``_build/``) and byte code."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if os.path.exists(backup_dir):
        shutil.rmtree(backup_dir)
    shutil.copytree(pkg_root, backup_dir,
                    ignore=shutil.ignore_patterns("_build", "__pycache__", "*.pyc", ".git*"))
