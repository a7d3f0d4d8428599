"""`scripts/torch_kernel_parts.py` against the kernels' sources, on the CPU.

The script times copies of a kernel with one part removed: it writes each
copy by replacing texts of the source with preprocessor switches, and it
stops if a text is not found exactly once. On the card that check runs only
when the script does; here it runs for every kernel of the script's table of
the kernels as they are, with no `nvcc`: a kernel edited without its
switches fails here. Every switch a variant sets must also be read by the
copy, so a variant cannot time the whole kernel under another name."""
import importlib.util
import pathlib
import re

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


def _parts():
    spec = importlib.util.spec_from_file_location(
        "torch_kernel_parts", REPO / "scripts" / "torch_kernel_parts.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


PARTS = _parts()


@pytest.mark.parametrize("name", sorted(PARTS.CURRENT))
def test_switches_apply_to_the_source(tmp_path, monkeypatch, name):
    monkeypatch.setattr(PARTS, "OUT", str(tmp_path))
    source = (PARTS.cuda_build.CSRC / f"{name}.cu").read_text()
    patches, variants = PARTS.CURRENT[name]
    for old, _ in patches:
        assert source.count(old) == 1, old
    path = PARTS.write_copy("current", name, str(PARTS.cuda_build.CSRC))
    copy = pathlib.Path(path).read_text()
    assert path.startswith(str(tmp_path))
    assert f"{PARTS.ATTRS[name]}(C, ts, out)" in copy
    assert "whole" in variants
    for variant, defines in variants.items():
        for define in defines:
            macro = define.split("=")[0]
            assert re.search(rf"\b{macro}\b", copy), (
                variant, macro)
