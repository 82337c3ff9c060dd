"""The port stands alone: no module of ``repro_torch`` imports ``jax`` or the
JAX package ``repro``.

In a fresh interpreter whose import system refuses both (and records who
asked), every module under ``src/repro_torch`` is imported by
``pkgutil.walk_packages``.  The test fails if any import fails, if any
frame of ``repro_torch`` asked for either package (even inside a
``try``), or if either ends up in ``sys.modules``.
"""
import json
import pathlib
import subprocess
import sys

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

CHILD = r"""
import importlib, importlib.abc, json, pkgutil, sys, traceback

REFUSED = ("jax", "jaxlib", "repro")
asked = []


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] not in REFUSED:
            return None
        f, who = sys._getframe(1), None
        while f is not None:
            mod = f.f_globals.get("__name__", "")
            if mod.split(".")[0] == "repro_torch":
                who = mod
                break
            f = f.f_back
        asked.append([name, who])
        raise ImportError(f"{name} is refused in this check")


sys.meta_path.insert(0, Refuse())
import repro_torch
failed, seen = {}, []
for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.",
                                  onerror=lambda n: failed.setdefault(n, "walk")):
    seen.append(info.name)
    try:
        importlib.import_module(info.name)
    except Exception:
        failed[info.name] = traceback.format_exc(limit=3)
print(json.dumps({"seen": seen, "failed": failed, "asked": asked,
                  "loaded": sorted(m for m in sys.modules
                                   if m.split(".")[0] in REFUSED)}))
"""


def test_no_repro_torch_module_imports_jax_or_repro():
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=SRC,
                          capture_output=True, text=True, timeout=300,
                          env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
                               "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    # every module of the package was imported, the new ones included
    assert {"repro_torch.analysis.traversal", "repro_torch.core.odeint",
            "repro_torch.launch.dryrun",
            "repro_torch.launch.analysis"} <= set(out["seen"])
    assert len(out["seen"]) >= 70
    assert out["failed"] == {}, out["failed"]
    assert [a for a in out["asked"] if a[1] is not None] == [], out["asked"]
    assert out["loaded"] == []
