"""Importing the package must not touch any device.

A module-scope ``jnp.float32(...)`` (or any other jnp scalar/array
construction) is a device-array construction, which initializes the
default PJRT backend at IMPORT time — before a CLI's ``--device`` choice
or a test's platform selection can apply, and on a GPU machine it also
reserves most of the card's memory in every process that merely imports
the package.  The rule: imports build Python objects only; the first
array op after the entry point's platform selection is what initializes
a backend.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def test_package_import_initializes_no_backend():
    code = (
        "import stereomatch_tpu\n"
        "import stereomatch_tpu.parallel\n"
        "import stereomatch_tpu.stream\n"
        "import stereomatch_tpu.tune\n"
        "import stereomatch_tpu.cli.image, stereomatch_tpu.cli.video\n"
        "import stereomatch_tpu.cli.serve, stereomatch_tpu.cli.evaluate\n"
        "import jax._src.xla_bridge as xb\n"
        "import json\n"
        "print(json.dumps(sorted(xb._backends)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    initialized = json.loads(out.stdout.strip().splitlines()[-1])
    assert initialized == [], (
        f"importing stereomatch_tpu initialized backends {initialized}; "
        "some module-scope code constructs device values (see module "
        "docstring)")


def test_entry_scripts_import_without_backend():
    """bench.py and chip_smoke.py select the platform and the compile
    cache in main(); importing them must not start a backend."""
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "import bench, chip_smoke\n"
        "import jax._src.xla_bridge as xb\n"
        "import json\n"
        "print(json.dumps(sorted(xb._backends)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_cli_runtime_setup_selects_platform_and_cache():
    """The CLIs' shared start-up (cli_common.setup_runtime): --device
    picks the platform, the compile cache goes to the checkout's
    .jax_cache/ when JAX_COMPILATION_CACHE_DIR is unset."""
    code = (
        "import jax\n"
        "from stereomatch_tpu.cli_common import setup_runtime\n"
        "setup_runtime('cpu')\n"
        "print(jax.config.jax_platforms)\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
    )
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr
    platform, cache = out.stdout.strip().splitlines()[-2:]
    assert platform == "cpu"
    assert Path(cache) == REPO / ".jax_cache"
