"""AST idiom linter over the port's source (rule codes MAGI001..MAGI005).

The JAX package's ``analysis/lint.py``, aimed at PyTorch. It walks python
source ASTs (no imports) and enforces the repo rules that keep the
distributed runtime portable and legible:

- **MAGI002** — no environment reads (``os.environ`` / ``os.getenv``, and
  ``from os import environ``) outside ``env.py``. Every flag gets one
  documented accessor, so planning-relevant flags can be folded into
  ``flags_fingerprint``.
- **MAGI003** — no host syncs on device tensors in the ``ops/`` /
  ``parallel/`` / ``serving/`` / ``comm/`` hot paths: ``.item()``,
  ``.cpu()``, ``.numpy()``, ``torch.cuda.synchronize()``, and ``.tolist()``
  / ``float()`` / ``int()`` / ``bool()`` of a tensor. Which values are
  tensors is a heuristic (see :meth:`_Linter._tensorish`): a function's
  ``torch.Tensor``-annotated parameters, the paged cache's tensor fields
  (``seq_lens``, ``block_tables``, ``k_pages``, ``v_pages``), the names
  assigned from expressions over them or over a ``torch.*`` call, those
  expressions themselves less their host metadata (``.shape``,
  ``.numel()`` ...), and mask reductions (``.any()``, ``.all()``). A
  sync stalls the host behind the card's queue and serialises the
  pipeline; the deliberate ones (a one-time host build, a digest, a shadow
  check's read) are allowlisted with their reason.
- **MAGI005** — no rank-dependent host control flow (``if`` / ``while`` /
  ternary) lexically guarding a collective issue site. The rank sources are
  ``dist.get_rank`` and the comm layer's ``group_rank``; the collectives are
  the ``torch.distributed`` collectives and the comm layer's functions. A
  rank-gated branch around a collective is the static root cause of
  cross-rank schedule divergence (one rank issues an extra or a missing
  collective and every rank hangs); ``analysis/spmd_audit.py`` is the
  recorded half of this check.

**MAGI001** (direct ``shard_map`` / Pallas compiler params outside
``utils/compat.py``) and **MAGI004** (collectives under ``named_scope``)
are JAX idioms with no counterpart here: their codes stay in :data:`RULES`
(so an allowlist or pragma naming them parses) and are not checked. The
port's own import rule (no ``jax``, nothing of the JAX package) is
``tests/test_torch_isolation.py``'s.

Deliberate exceptions live in ``allowlist.json`` beside this module as
``{rule, path, symbol, justification}`` records (symbol = dotted enclosing
def/class scope, ``"*"`` wildcard), or inline as a ``# magi-allow:
MAGI00X`` comment on the flagged line. An allowlist entry that matches
nothing is reported as stale.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
from typing import Iterable, Sequence

RULES: dict[str, str] = {
    "MAGI001": "not checked in the port (a JAX idiom: shard_map / pltpu.CompilerParams)",
    "MAGI002": "environment read outside env.py — add an env.py accessor",
    "MAGI003": "host sync on a device tensor inside a hot path",
    "MAGI004": "not checked in the port (a JAX idiom: collectives under named_scope)",
    "MAGI005": (
        "rank-dependent host control flow guards a collective issue site — per-rank "
        "schedule divergence (a hang); issue the collective on every rank"
    ),
}
CHECKED_RULES = ("MAGI002", "MAGI003", "MAGI005")

# rule scopes (path prefixes are repo-relative, posix separators)
PACKAGE = "magiattention_tpu_torch"
_ENV_FILE = f"{PACKAGE}/env.py"
_HOT_PATHS = tuple(f"{PACKAGE}/{d}/" for d in ("ops", "parallel", "serving", "comm"))
_ALWAYS_SYNC = ("item", "cpu", "numpy")  # methods only a tensor has that read it
_HOST_META = ("shape", "dtype", "device", "ndim", "is_cuda", "numel", "dim", "size",
              "element_size", "data_ptr", "stride", "nelement")
_HOST_CALLS = ("int", "float", "bool", "len", "str", "tuple", "list", "range", "isinstance")
_TENSOR_FIELDS = ("seq_lens", "block_tables", "k_pages", "v_pages")  # the paged cache's
_MASK_REDUCTIONS = ("any", "all")
_RANK_SOURCES = ("get_rank", "group_rank")
# collective issue sites: torch.distributed's collectives and the comm layer's
_COLLECTIVES = (
    "all_reduce", "all_gather", "all_gather_object", "all_gather_into_tensor", "broadcast",
    "broadcast_object_list", "all_to_all", "all_to_all_single", "reduce_scatter",
    "reduce_scatter_tensor", "batch_isend_irecv", "barrier", "send", "recv", "isend",
    "irecv", "gather", "scatter",
    "exchange", "all_to_all_rows", "all_gather_v", "all2all_v", "group_cast", "group_cast_m",
    "cast_transpose", "group_reduce_sum", "group_reduce_lse", "return_rows",
    "group_cast_hier", "group_reduce_hier", "replicated",
)
_COLLECTIVE_FUNCTIONS = ("GroupCast", "GroupCastHier", "ReturnRows")  # their .apply
_PRAGMA = "# magi-allow:"
ALLOWLIST = os.path.join(os.path.dirname(__file__), "allowlist.json")


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    path: str  # repo-relative posix path
    line: int
    symbol: str  # dotted enclosing scope, "<module>" at top level
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message} [{self.symbol}]"


def _attr_chain(node: ast.AST) -> str | None:
    """``a.b.c`` -> "a.b.c" for pure Name/Attribute chains, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _leaf(node: ast.AST) -> str:
    chain = _attr_chain(node) or ""
    return chain.split(".")[-1] if chain else (
        node.attr if isinstance(node, ast.Attribute) else "")


def _is_numpy_expr(node: ast.AST) -> bool:
    """A call whose callee chain starts at ``np`` / ``numpy`` (a host array)."""
    while isinstance(node, (ast.Call, ast.Attribute, ast.Subscript)):
        node = node.func if isinstance(node, ast.Call) else node.value
    return isinstance(node, ast.Name) and node.id in ("np", "numpy")


def _torch_rooted(node: ast.AST) -> bool:
    chain = _attr_chain(node)
    return bool(chain) and chain.split(".")[0] == "torch"


def _tensor_params(fn) -> set[str]:
    args = fn.args
    params = list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs)
    out = set()
    for a in params:
        if a.annotation is not None and "Tensor" in ast.unparse(a.annotation):
            out.add(a.arg)
    return out


def _is_collective_call(node: ast.Call) -> bool:
    chain = _attr_chain(node.func) or ""
    parts = chain.split(".")
    if parts[-1] in _COLLECTIVES:
        return True
    return len(parts) >= 2 and parts[-1] == "apply" and parts[-2] in _COLLECTIVE_FUNCTIONS


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str, source: str):
        self.path = path
        self.lines = source.splitlines()
        self.violations: list[Violation] = []
        self._scope: list[str] = []
        self._in_hot_path = path.startswith(_HOT_PATHS)
        self._tensor_params: list[set[str]] = [set()]
        # names bound from a rank source, one set per lexical scope (nested
        # scopes inherit: a closure over the rank is still the rank)
        self._rank_names: list[set[str]] = [set()]

    # -- helpers --------------------------------------------------------

    def _symbol(self) -> str:
        return ".".join(self._scope) if self._scope else "<module>"

    def _flag(self, rule: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 0)
        # inline pragma: `# magi-allow: MAGI003` (optionally several
        # comma-separated codes) anywhere on the flagged line
        if 0 < line <= len(self.lines):
            text = self.lines[line - 1]
            if _PRAGMA in text:
                allowed = text.split(_PRAGMA, 1)[1]
                if rule in [c.strip() for c in allowed.split(",")]:
                    return
        self.violations.append(Violation(rule, self.path, line, self._symbol(), message))

    # -- scope tracking -------------------------------------------------

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._scope.append(node.name)
        self.generic_visit(node)
        self._scope.pop()

    def _visit_function(self, node) -> None:
        self._scope.append(node.name)
        self._tensor_params.append(_tensor_params(node))
        self._rank_names.append(set(self._rank_names[-1]))
        self.generic_visit(node)
        self._rank_names.pop()
        self._tensor_params.pop()
        self._scope.pop()

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    # -- MAGI005: rank-gated host control flow over collectives ----------

    def visit_Assign(self, node: ast.Assign) -> None:
        is_rank = isinstance(node.value, ast.Call) and _leaf(node.value.func) in _RANK_SOURCES
        is_tensor = self._tensorish(node.value)
        for t in node.targets:
            if isinstance(t, ast.Name):
                if is_rank:
                    self._rank_names[-1].add(t.id)
                else:
                    # rebinding to a non-rank value clears the taint
                    self._rank_names[-1].discard(t.id)
                if is_tensor:
                    self._tensor_params[-1].add(t.id)
                else:
                    self._tensor_params[-1].discard(t.id)
        self.generic_visit(node)

    def _mentions_rank(self, node: ast.AST) -> bool:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) and _leaf(sub.func) in _RANK_SOURCES:
                return True
            if isinstance(sub, ast.Name) and sub.id in self._rank_names[-1]:
                return True
        return False

    def _check_rank_gate(self, node, guarded) -> None:
        if self._mentions_rank(node.test) and any(
                isinstance(sub, ast.Call) and _is_collective_call(sub)
                for n in guarded for sub in ast.walk(n)):
            self._flag("MAGI005", node, RULES["MAGI005"])

    def visit_If(self, node: ast.If) -> None:
        self._check_rank_gate(node, node.body + node.orelse)
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        self._check_rank_gate(node, node.body + node.orelse)
        self.generic_visit(node)

    def visit_IfExp(self, node: ast.IfExp) -> None:
        self._check_rank_gate(node, [node.body, node.orelse])
        self.generic_visit(node)

    # -- MAGI002 ----------------------------------------------------------

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        names = {a.name for a in node.names}
        if self.path != _ENV_FILE and node.module == "os" and names & {"environ", "getenv"}:
            # `from os import environ` would let every later use evade the
            # os.environ chain check: flag the import itself
            self._flag("MAGI002", node, RULES["MAGI002"])
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if _attr_chain(node) == "os.environ" and self.path != _ENV_FILE:
            self._flag("MAGI002", node, RULES["MAGI002"])
        self.generic_visit(node)

    # -- MAGI002 / MAGI003 calls -------------------------------------------

    def _tensorish(self, expr: ast.AST) -> bool:
        """Whether ``expr`` is (heuristically) a tensor value: it reads a
        tensor name or a ``torch.*`` call, and is neither host metadata of
        one (``x.shape[0]``, ``x.numel()``), a host conversion (``int(..)``,
        ``len(..)``) nor a numpy expression."""
        if isinstance(expr, ast.Call) and (
                (_attr_chain(expr.func) or "") in _HOST_CALLS or _is_numpy_expr(expr)):
            return False
        names = self._tensor_params[-1]
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Attribute) and sub.attr in _HOST_META:
                return False
        if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute) and \
                expr.func.attr in _MASK_REDUCTIONS:
            return True  # a mask reduction read as a host bool
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Name) and sub.id in names:
                return True
            if isinstance(sub, ast.Attribute) and sub.attr in _TENSOR_FIELDS:
                return True
            if isinstance(sub, ast.Call) and _torch_rooted(sub.func) and \
                    _attr_chain(sub.func) != "torch.cuda.synchronize":
                return True
        return False

    def visit_Call(self, node: ast.Call) -> None:
        chain = _attr_chain(node.func) or ""
        if chain == "os.getenv" and self.path != _ENV_FILE:
            self._flag("MAGI002", node, RULES["MAGI002"])
        if self._in_hot_path:
            method = node.func.attr if isinstance(node.func, ast.Attribute) else ""
            if method in _ALWAYS_SYNC and not _is_numpy_expr(node.func.value):
                self._flag("MAGI003", node, f".{method}() reads a tensor on the host")
            elif method == "tolist" and self._tensorish(node.func.value):
                self._flag("MAGI003", node, ".tolist() of a tensor reads it on the host")
            elif chain == "torch.cuda.synchronize":
                self._flag("MAGI003", node, "torch.cuda.synchronize() stalls the host")
            elif chain in ("float", "int", "bool") and node.args and \
                    self._tensorish(node.args[0]):
                self._flag("MAGI003", node, f"{chain}() of a tensor reads it on the host")
        self.generic_visit(node)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def lint_source(source: str, path: str) -> list[Violation]:
    """Lint one python source blob; ``path`` is the repo-relative posix
    path used for rule scoping (the env.py exemption, the MAGI003 hot
    paths)."""
    tree = ast.parse(source, filename=path)
    linter = _Linter(path, source)
    linter.visit(tree)
    return linter.violations


def lint_paths(root: str, rel_paths: Iterable[str]) -> list[Violation]:
    out: list[Violation] = []
    for rel in sorted(rel_paths):
        with open(os.path.join(root, rel), "r", encoding="utf-8") as f:
            src = f.read()
        out.extend(lint_source(src, rel.replace(os.sep, "/")))
    return out


def _python_files(root: str, subdir: str) -> list[str]:
    found = []
    for dirpath, dirnames, filenames in os.walk(os.path.join(root, subdir)):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__", ".git", "build")]
        for name in filenames:
            if name.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, name), root)
                found.append(rel.replace(os.sep, "/"))
    return found


def lint_package(root: str) -> list[Violation]:
    """Lint every python file of the port's package under ``root`` (the
    repo checkout)."""
    return lint_paths(root, _python_files(root, PACKAGE))


# ---------------------------------------------------------------------------
# allowlist
# ---------------------------------------------------------------------------


def load_allowlist(path: str = ALLOWLIST) -> list[dict]:
    with open(path, "r", encoding="utf-8") as f:
        entries = json.load(f)
    for e in entries:
        missing = {"rule", "path", "symbol", "justification"} - set(e)
        if missing:
            raise ValueError(f"allowlist entry {e!r} missing fields {sorted(missing)}")
        if not str(e["justification"]).strip():
            raise ValueError(f"allowlist entry {e!r} needs a justification")
    return entries


def apply_allowlist(violations: Sequence[Violation], entries: Sequence[dict]
                    ) -> tuple[list[Violation], list[dict]]:
    """Filter ``violations`` through the allowlist.

    Returns ``(remaining, stale_entries)`` — stale entries matched nothing
    and should be deleted (the violation they covered is gone), keeping the
    allowlist an honest record instead of a grandfather file."""
    used = [False] * len(entries)
    remaining: list[Violation] = []
    for v in violations:
        suppressed = False
        for i, e in enumerate(entries):
            if e["rule"] == v.rule and e["path"] == v.path and (
                    e["symbol"] == "*" or e["symbol"] == v.symbol):
                used[i] = True
                suppressed = True
        if not suppressed:
            remaining.append(v)
    stale = [e for i, e in enumerate(entries) if not used[i]]
    return remaining, stale


def lint_errors(root: str, allowlist: str = ALLOWLIST) -> list[str]:
    """The lint pass: every violation the allowlist does not cover, and every
    stale allowlist entry, rendered."""
    remaining, stale = apply_allowlist(lint_package(root), load_allowlist(allowlist))
    errors = [v.render() for v in remaining]
    for e in stale:
        errors.append(f"stale allowlist entry (no matching violation — delete it): "
                      f"{e['rule']} {e['path']} [{e['symbol']}]")
    return errors
