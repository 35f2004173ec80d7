"""Nothing the harness imports loads JAX or the JAX package, compared by
whole top-level module names (`mebt_tpu_torch` begins with `mebt_tpu`),
and the reference loads nothing of the program."""

from __future__ import annotations

import json
import subprocess
import sys

from portbench import manifest

PROBE = r"""
import importlib, json, pkgutil, sys
import portbench
mods = [m.name for m in pkgutil.walk_packages(portbench.__path__, "portbench.")
        if ".tests" not in m.name and m.name != "portbench.run"]
for m in mods + ["portbench.run"]:
    importlib.import_module(m)
from portbench import manifest
for m in manifest.load()["per_layer"]:
    manifest.metric_reader(m["name"])
import portbench.drivers.generate as g
top = sorted({k.split(".")[0] for k in sys.modules})
print(json.dumps({"mods": mods, "top": top}))
"""

REF = r"""
import json, sys
import portbench.reference.mebt, portbench.reference.vqgan
print(json.dumps(sorted({k.split(".")[0] for k in sys.modules})))
"""


def _run(code: str):
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_no_module_of_the_harness_loads_jax_or_the_jax_package():
    got = _run(PROBE)
    assert "portbench.drivers.generate" in got["mods"]
    assert not set(got["top"]) & {"jax", "jaxlib", "flax", "mebt_tpu"}, got["top"]


def test_the_reference_loads_nothing_of_the_program():
    top = _run(REF)
    assert "mebt_tpu_torch" not in top and "mebt_tpu" not in top and "jax" not in top
