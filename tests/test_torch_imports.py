"""The PyTorch port stands alone: it imports neither JAX nor the reference
package, in a fresh interpreter and in its source text."""

import re
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"


def test_port_imports_without_jax_or_reference_package():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.linalg, repro_torch.kernels\n"
        "import repro_torch.models, repro_torch.serving, repro_torch.configs\n"
        "import repro_torch.serving.serve_lm, repro_torch.models.ssm\n"
        "import repro_torch.linalg.lu, repro_torch.linalg.qr\n"
        "import repro_torch.linalg.panels, repro_torch.linalg.dist\n"
        "import repro_torch.core.static_schedule, repro_torch.exec.replay\n"
        "import repro_torch.replay.recording, repro_torch.replay.cache\n"
        "import repro_torch.replay.executor, repro_torch.replay.remap\n"
        "import repro_torch.replay.pool\n"
        "import repro_torch.compile, repro_torch.compile.capture\n"
        "import repro_torch.compile.driver, repro_torch.compile.plan\n"
        "import repro_torch.obs, repro_torch.obs.trace\n"
        "import repro_torch.obs.perfetto, repro_torch.obs.export\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=SRC,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|repro)\b(?!_torch)"
    r"|from\s+(jax|jaxlib|repro)(\.|\s)(?!_torch))", re.M)


def test_port_source_has_no_jax_or_reference_imports():
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    assert len(files) > 20
    offenders = []
    for f in files:
        for m in _FORBIDDEN.finditer(f.read_text()):
            offenders.append(f"{f.relative_to(SRC)}: {m.group(0).strip()}")
    assert not offenders, offenders
