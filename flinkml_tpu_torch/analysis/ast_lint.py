"""Source-level pipeline lint — pass 1 for scripts.

The port's counterpart of ``flinkml_tpu.analysis.ast_lint``. A linted
script's stage class names resolve in ``flinkml_tpu_torch.models``,
whichever package the script imports (the JAX package's scripts and the
port's build the same stages under the same names); the script is read,
never run.

Example/user scripts build pipelines at the top of a training run; running
them to validate them defeats the point of *ahead-of-time* checking. This
module reconstructs ``Pipeline([...])`` / ``PipelineModel([...])`` chains
from the AST instead:

  - each stage expression (``Cls().set_input_cols([...]).set(Cls.OUTPUT_COL,
    "x").fit(t)``) is peeled into a class name + param overrides;
  - the real stage class is looked up in ``flinkml_tpu_torch.models`` and
    instantiated (cheap, device-free) so **class-default column params
    participate** — chains that only connect through defaults (scaler
    default input ``"input"``/output ``"output"``) are checked for real;
  - the chain then flows through :func:`.validator.analyze_pipeline`
    with an *open* schema (source data columns are unknowable), which
    still catches output collisions (FML102) and consume-before-produce
    ordering (FML107).

Param values are resolved by a restricted constant evaluator: literals,
previously assigned module-level constants, f-strings, ``range`` list
comprehensions and arithmetic — enough for real scripts, with anything
fancier degrading to "unknown" (the affected check is skipped, never
guessed).
"""

from __future__ import annotations

import ast
import os
from typing import Any, Dict, List, Optional, Tuple

from flinkml_tpu_torch.analysis.findings import Finding, Report
from flinkml_tpu_torch.analysis.validator import analyze_pipeline

_PIPELINE_NAMES = {"Pipeline", "PipelineModel"}

#: Node types the restricted evaluator may execute. Anything else makes the
#: expression "unknown" rather than executed.
_SAFE_NODES = (
    ast.Expression, ast.Constant, ast.Name, ast.Load, ast.Store, ast.List,
    ast.Tuple,
    ast.Dict, ast.Set, ast.BinOp, ast.UnaryOp, ast.Add, ast.Sub, ast.Mult,
    ast.Div, ast.FloorDiv, ast.Mod, ast.USub, ast.UAdd, ast.JoinedStr,
    ast.FormattedValue, ast.ListComp, ast.comprehension, ast.Call,
    ast.Starred, ast.Subscript, ast.Slice, ast.Index if hasattr(ast, "Index") else ast.Slice,
)
_SAFE_CALLS = {"range": range, "len": len, "str": str, "int": int,
               "float": float, "list": list, "tuple": tuple}


class _Unknown:
    """Sentinel: the expression could not be resolved statically."""

    def __repr__(self):  # pragma: no cover
        return "<unknown>"


UNKNOWN_VALUE = _Unknown()


def _safe_eval(node: ast.AST, env: Dict[str, Any]) -> Any:
    """Evaluate ``node`` if it only uses whitelisted constructs and names
    from ``env``; returns :data:`UNKNOWN_VALUE` otherwise."""
    bound = {
        t.id
        for sub in ast.walk(node) if isinstance(sub, ast.comprehension)
        for t in ast.walk(sub.target) if isinstance(t, ast.Name)
    }
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            if not (isinstance(sub.func, ast.Name)
                    and sub.func.id in _SAFE_CALLS):
                return UNKNOWN_VALUE
        elif not isinstance(sub, _SAFE_NODES):
            return UNKNOWN_VALUE
        if isinstance(sub, ast.Name) and sub.id not in env \
                and sub.id not in _SAFE_CALLS and sub.id not in bound:
            return UNKNOWN_VALUE
    try:
        code = compile(ast.Expression(body=node), "<analysis>", "eval")
        return eval(  # noqa: S307 — whitelisted node types + names only
            code, {"__builtins__": dict(_SAFE_CALLS)}, dict(env)
        )
    except Exception:
        return UNKNOWN_VALUE


def _collect_constants(tree: ast.Module) -> Dict[str, Any]:
    """Module-level ``name = <resolvable>`` assignments (including tuple
    unpacking), in order, so later expressions can reference them."""
    env: Dict[str, Any] = {}
    for stmt in tree.body:
        if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
            continue
        target = stmt.targets[0]
        if isinstance(target, ast.Name):
            v = _safe_eval(stmt.value, env)
            if v is not UNKNOWN_VALUE:
                env[target.id] = v
        elif isinstance(target, ast.Tuple) and all(
                isinstance(e, ast.Name) for e in target.elts):
            v = _safe_eval(stmt.value, env)
            if v is not UNKNOWN_VALUE:
                try:
                    vals = list(v)
                except TypeError:
                    continue
                if len(vals) == len(target.elts):
                    for name_node, val in zip(target.elts, vals):
                        env[name_node.id] = val
    return env


def _peel_chain(expr: ast.AST) -> Tuple[Optional[str], List[ast.Call]]:
    """Split ``Cls(...).m1(...).m2(...)`` into (class name, [m1, m2, ...]).

    Returns ``(None, [])`` for anything that is not a constructor-rooted
    call chain (e.g. a bare variable reference).
    """
    calls: List[ast.Call] = []
    node = expr
    while isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Name):
            return f.id, list(reversed(calls))
        if isinstance(f, ast.Attribute):
            calls.append(node)
            node = f.value
        else:
            return None, []
    return None, []


def _camel(method: str) -> str:
    """``set_input_cols`` -> ``inputCols``."""
    parts = method.split("_")[1:]
    if not parts:
        return ""
    return parts[0] + "".join(p.title() for p in parts[1:])


class _OpaqueStage:
    """Placeholder for a stage the lint cannot model; analyze_pipeline
    treats it as opaque (schema goes open after it)."""

    def transform_kernel(self):
        return None


def _build_stage(cls_name: str, calls: List[ast.Call],
                 env: Dict[str, Any]):
    """Instantiate the real stage class and replay the statically
    resolvable param-setting calls onto it. Returns an _OpaqueStage when
    the class is unknown or a column param cannot be resolved."""
    import flinkml_tpu_torch.models as models

    cls = getattr(models, cls_name, None)
    if cls is None:
        return _OpaqueStage()
    try:
        stage = cls()
        params_by_name = {p.name: p for p in cls.params()}
    except Exception:
        return _OpaqueStage()

    for call in calls:
        method = call.func.attr
        if method == "fit":
            # Estimator -> Model: column params carry over unchanged; the
            # estimator instance already holds them.
            continue
        if method == "set" and len(call.args) == 2:
            pnode, vnode = call.args
            if not isinstance(pnode, ast.Attribute):
                return _OpaqueStage()
            param = getattr(cls, pnode.attr, None)
            value = _safe_eval(vnode, env)
        elif method.startswith("set_") and len(call.args) == 1:
            param = params_by_name.get(_camel(method))
            if param is None:
                continue  # non-param fluent setter; ignore
            value = _safe_eval(call.args[0], env)
        else:
            continue
        if param is None:
            continue
        if value is UNKNOWN_VALUE:
            pname = getattr(param, "name", "")
            if "Col" in pname or "col" in pname:
                # A column wired through something we can't resolve —
                # modelling the stage with the default would produce
                # false findings; degrade to opaque.
                return _OpaqueStage()
            continue
        try:
            stage.set(param, value)
        except Exception:
            return _OpaqueStage()
    return stage


def lint_source(source: str, filename: str = "<source>") -> Report:
    """Lint one script: reconstruct every ``Pipeline([...])`` /
    ``PipelineModel([...])`` literal and validate its chain."""
    report = Report()
    try:
        tree = ast.parse(source, filename=filename)
    except SyntaxError as e:
        report.add(Finding("FML101", f"could not parse: {e}",
                           location=filename))
        return report
    env = _collect_constants(tree)

    # Stage variables assigned earlier and referenced by name inside the
    # pipeline list: remember their defining expression.
    stage_exprs: Dict[str, ast.AST] = {}
    for stmt in ast.walk(tree):
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name) \
                and isinstance(stmt.value, ast.Call):
            stage_exprs[stmt.targets[0].id] = stmt.value

    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, (ast.Name, ast.Attribute))):
            continue
        fname = node.func.id if isinstance(node.func, ast.Name) \
            else node.func.attr
        if fname not in _PIPELINE_NAMES or not node.args:
            continue
        arg = node.args[0]
        if not isinstance(arg, (ast.List, ast.Tuple)):
            continue
        stages = []
        for elt in arg.elts:
            expr = elt
            if isinstance(expr, ast.Name) and expr.id in stage_exprs:
                expr = stage_exprs[expr.id]
            cls_name, calls = _peel_chain(expr)
            stages.append(
                _build_stage(cls_name, calls, env) if cls_name
                else _OpaqueStage()
            )
        location = f"{filename}:{node.lineno}"
        report.extend(analyze_pipeline(stages, schema=None,
                                       location=location))
    return report


def lint_paths(paths) -> Report:
    """Lint every ``.py`` file in ``paths`` (files or directories)."""
    report = Report()
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, names in os.walk(p):
                if "__pycache__" in root:
                    continue
                files.extend(
                    os.path.join(root, n) for n in sorted(names)
                    if n.endswith(".py")
                )
        elif p.endswith(".py"):
            files.append(p)
    for f in files:
        with open(f, "r") as fh:
            report.extend(lint_source(fh.read(), filename=f))
    return report
