"""Import guard of the port: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the reference package, by source (an
``ast`` walk) and at run time (a fresh interpreter's ``sys.modules``)."""
import ast
import pathlib
import subprocess
import sys

import jax  # noqa: F401  (both frameworks load in this process, as in the others)
import pytest
import torch  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_source_imports_no_jax_or_reference(path):
    bad = sorted(n for n in _imported(path)
                 if n.split(".")[0] in FORBIDDEN)
    assert bad == [], f"{path.relative_to(REPO)} imports {bad}"


def test_port_runs_without_loading_jax():
    code = ("import sys\n"
            "import repro_torch, repro_torch.bridge, repro_torch.launch.serve\n"
            "import repro_torch.serve.engine, repro_torch.kernels.ref\n"
            "import repro_torch.core.runtime, repro_torch.optim.compress\n"
            "import repro_torch.serve.quant, repro_torch.models.rwkv6\n"
            "import repro_torch.models.rwkv_lm, repro_torch.kernels.rwkv6_scan\n"
            "import repro_torch.models.mamba2, repro_torch.models.zamba\n"
            "import repro_torch.kernels.ssd_scan, repro_torch.core\n"
            "import repro_torch.apps.mcmc, repro_torch.apps.dmc\n"
            "import repro_torch.apps.boussinesq, repro_torch.launch.apps\n"
            "import repro_torch.serve.disagg, repro_torch.configs.qwen2p5_14b\n"
            "import repro_torch.models.moe, repro_torch.serve.placement\n"
            "import repro_torch.configs.qwen3_moe_235b\n"
            "import repro_torch.configs.arctic_480b\n"
            "import repro_torch.core.comm, repro_torch.models.api\n"
            "import repro_torch.models.module, repro_torch.models.transformer\n"
            "import repro_torch.serve.pages, repro_torch.serve.spec\n"
            "import repro_torch.serve.traffic, repro_torch.launch.collectives\n"
            "import repro_torch.models.whisper\n"
            "import repro_torch.configs.llava_next_mistral_7b\n"
            "import repro_torch.configs.whisper_tiny\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={"PYTHONPATH": str(REPO / "src"),
                               "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
