"""The port stands alone: importing ``accl_tpu_torch`` (every module) loads
neither ``jax`` nor ``accl_tpu``, and no source of the port or of
``chip_smoke.py`` imports them."""
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "accl_tpu_torch"


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|accl_tpu)(?:[.\s]|$)",
                     re.MULTILINE)


def _modules():
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_import_loads_no_jax():
    mods = list(_modules())
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'accl_tpu' or "
            "m.startswith('accl_tpu.'))\n"
            "print('LEAKED', bad) if bad else print('CLEAN')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("CLEAN"), r.stdout[-2000:]
    # and no source of the port or of chip_smoke.py names them
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for p in files:
        hits = _IMPORT.findall(p.read_text())
        assert not hits, f"{p.relative_to(ROOT)} imports {hits}"
