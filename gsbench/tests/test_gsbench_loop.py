"""The drivers against the program's own loops: the train driver's
iteration makes the calls of ``Trainer.train``'s iteration, in its order
and under its cadence, apart from what the traffic leaves out (checkpoints,
evals, the writer, the viewer); the render driver builds the program's
``Renderer`` through the two loaders its constructor calls. Each fails
when the program's loop changes, so that the benchmark is brought up to
date with it."""

from __future__ import annotations

import ast
import inspect
import textwrap

# calls of Trainer.train's iteration that the traffic leaves out
LEFT_OUT = {"timer", "put_dict", "put_scalar", "write_out_storage", "perf_counter",
            "max", "float", "items", "scene_to_rank0", "update_scene",
            "_save_checkpoint", "eval_image", "eval_all"}
# the step function is a local: the trainer's ``step_fn``, the driver's ``fn``
ALIASES = {"fn": "step_fn"}


def _calls(node: ast.AST):
    """The names of the calls under ``node``, in source order."""
    out = []
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            f = n.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
            out.append((n.lineno, n.col_offset, ALIASES.get(name, name)))
    return [name for _, _, name in sorted(out)]


def _guards(node: ast.AST, names):
    """For each call in ``names``, the source of the ``if`` test that
    guards it."""
    out = {}
    for n in ast.walk(node):
        if isinstance(n, ast.If):
            for name in _calls(ast.Module(body=n.body, type_ignores=[])):
                if name in names and name not in out:
                    out[name] = ast.unparse(n.test)
    return out


def _source(fn) -> ast.AST:
    return ast.parse(textwrap.dedent(inspect.getsource(fn)))


def test_the_train_driver_makes_trainer_trains_calls():
    from gstk_torch.train.trainer import Trainer

    from gsbench.drivers.train import TrainLoop

    loop = next(n for n in ast.walk(_source(Trainer.train)) if isinstance(n, ast.For))
    body = ast.Module(body=loop.body, type_ignores=[])
    want = [c for c in _calls(body) if c not in LEFT_OUT]
    mine = _source(TrainLoop.step_once)
    got = [c for c in _calls(mine) if c not in ("record_function", "_span", "int",
                                                  "float", "items")]
    assert got == want
    cadence = _guards(body, {"_refine", "_maybe_grow"})
    assert cadence == {
        "_refine": "(step + 1) % cfg.model.refine_every == 0",
        "_maybe_grow": "step % cfg.log_every == 0 or step == cfg.max_num_iterations - 1"}
    assert _guards(mine, {"_refine", "_maybe_grow"}) == {
        "_refine": "(step + 1) % model.refine_every == 0",
        "_maybe_grow": "step % int(self.traffic['log_every']) == 0"}


def test_the_render_driver_builds_the_programs_renderer():
    from gstk_torch.render import renderer

    calls = _calls(_source(renderer.Renderer.__init__))
    assert "load_scene" in calls and "peek_meta" in calls
    assert callable(renderer.load_scene) and callable(renderer.peek_meta)
    assert "get_output_from_pose" in dir(renderer.Renderer)
