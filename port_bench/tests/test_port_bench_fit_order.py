"""The training cell drives a copy of the per-step path of ``fit()``'s loop
(``kinds/train.py``'s ``step_once``), since ``fit()`` offers no way to
stop at a deadline. These tests fail when that loop's per-step order of
calls changes, so the copy cannot drift from what users run unseen."""
import ast

from port_bench import harness

FIT = harness.ROOT / "gsl_tpu_torch" / "training" / "fit.py"
TRAIN = harness.BENCH / "kinds" / "train.py"
# what a step reads and what changes the state, in order
PATH = ["next", "image_to_float", "step_hook", "after_step", "periodic",
        "density_hook", "periodic"]


def _name(call: ast.Call) -> str:
    f = call.func
    return f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")


def _targets(node: ast.Assign) -> set:
    return {n.id for t in node.targets for n in ast.walk(t)
            if isinstance(n, ast.Name)}


def state_path(body: list) -> list:
    """In source order, every call whose result is assigned to the state
    or the image, or that takes the next item from the loader."""
    out = []
    for stmt in body:
        if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call):
            name = _name(stmt.value)
            if name == "next" or _targets(stmt) & {"state", "img"}:
                out.append(name)
        for field in ("body", "orelse", "finalbody", "handlers"):
            out += state_path(getattr(stmt, field, []) or [])
    return out


def _function(tree, name):
    return next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == name)


def fit_step_body() -> list:
    fit = _function(ast.parse(FIT.read_text()), "fit")
    loop = next(n for n in ast.walk(fit) if isinstance(n, ast.For)
                and isinstance(n.target, ast.Name) and n.target.id == "step")
    return loop.body


def test_fits_loop_takes_the_path_the_cell_copies():
    assert state_path(fit_step_body()) == PATH


def test_the_cells_step_takes_fits_path():
    step_once = _function(ast.parse(TRAIN.read_text()), "step_once")
    assert state_path(step_once.body) == state_path(fit_step_body())
