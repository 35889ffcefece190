"""What a run imports: never the JAX stack or the JAX package; the
reference never the port."""
import subprocess
import sys

from portbench import harness

CHECK = """
import sys
sys.path.insert(0, {root!r})
from portbench import harness
{body}
bad = [m for m in sys.modules if m.split('.')[0] in {names!r}]
print(','.join(sorted(bad)))
"""


def _loaded(body: str, names) -> str:
    code = CHECK.format(root=str(harness.ROOT), body=body, names=tuple(names))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_harness_loads_no_jax():
    body = "\n".join([
        "import portbench.run, portbench.calibrate",
        "for k in ('generate', 'train'): harness.traffic_kind(k)",
        "import portbench.reference.models, portbench.reference.train",
        "from portbench.sd import port_configs",
        "port_configs(harness.load_json('configs', 'sd2'))"])
    assert _loaded(body, harness.FORBIDDEN) == ""


def test_reference_loads_no_port():
    body = "\n".join([
        "import portbench.reference.models, portbench.reference.samplers",
        "import portbench.reference.train, portbench.reference.quant, portbench.reference.layout"])
    assert _loaded(body, ("minddiffusion_tpu_torch",) + harness.FORBIDDEN) == ""


def test_forbidden_compares_whole_names():
    sys.modules.setdefault("minddiffusion_tpu_torch_probe", sys)
    try:
        assert "minddiffusion_tpu_torch_probe" not in harness.forbidden_loaded()
    finally:
        del sys.modules["minddiffusion_tpu_torch_probe"]
