"""Parser for the gin config-file dialect used by the reference configs.

Grammar actually exercised by reference ``config/*.gin`` files (see e.g.
config/tiger/amazon/rqvae.gin):

    # comment
    include "config/base.gin"
    import some.python.module
    MACRO_NAME = <value>
    target.param = <value>
    scope/target.param = <value>        (scopes accepted, treated as aliases)

Values are Python literals plus three gin extensions:
    %MACRO            -> macro table lookup
    %pkg.Enum.MEMBER  -> enum member (gin constants_from_enum)
    @Name / @Name()   -> configurable reference / evaluated reference

The files name the JAX package; ``import genrec_tpu.<mod>`` imports the
port's ``genrec_tpu_torch.<mod>`` and raises, naming the ROADMAP item
that ports it, where the port has no such module yet. Every other
``genrec_tpu.`` name is mapped the same way by ``registry.port_name``.
"""

from __future__ import annotations

import importlib
import os
import re
from typing import Any

from genrec_tpu_torch.configlib import registry

_MACROS: dict[str, Any] = {}

# JAX-package modules a config file may import that the port has not
# ported yet, and the ROADMAP item that ports each.
_ROADMAP_ITEM = {
    "models.sasrec": "A5 (SASRec on fused CE)",
    "trainers.sasrec_trainer": "A5 (SASRec on fused CE)",
    "trainers.tiger_trainer": "A9 (TIGER training)",
}

_REF_RE = re.compile(r"@([A-Za-z_][\w\./]*)(\(\))?")
_PCT_RE = re.compile(r"%([A-Za-z_][\w\.]*)")


def clear_macros() -> None:
    _MACROS.clear()


def _sub_refs(expr: str) -> str:
    """Rewrite @refs / %refs into resolver calls so eval() can handle them."""

    def ref(m: re.Match) -> str:
        name, call = m.group(1), m.group(2)
        return f"__ref__({name!r}, {bool(call)})"

    def pct(m: re.Match) -> str:
        return f"__pct__({m.group(1)!r})"

    # Protect string literals from substitution.
    parts = re.split(r"(\"[^\"]*\"|'[^']*')", expr)
    out = []
    for i, p in enumerate(parts):
        if i % 2 == 1:
            out.append(p)
        else:
            out.append(_PCT_RE.sub(pct, _REF_RE.sub(ref, p)))
    return "".join(out)


class MacroRef(registry.Ref):
    """A ``%NAME`` value, resolved lazily at injection time so that later
    redefinitions (notably ``--gin`` overrides applied after the file) win,
    matching gin's lazy macro semantics."""

    def __init__(self, name: str):
        self.name = name

    def resolve(self) -> Any:
        if self.name in _MACROS:
            return registry._materialize(_MACROS[self.name])
        member = registry.resolve_enum(self.name)
        if member is not None:
            return member
        raise KeyError(f"%{self.name}: unknown macro or enum constant")

    def __repr__(self):
        return f"MacroRef(%{self.name})"


def _resolve_pct(name: str) -> Any:
    # Fully lazy (gin semantics): forward references and --gin-supplied
    # macros are legal; unknown names fail at injection time instead.
    return MacroRef(name)


def parse_value(expr: str) -> Any:
    expr = expr.strip()
    env = {
        "__builtins__": {},
        "__ref__": lambda n, c: registry.ConfigurableRef(n, evaluate=c),
        "__pct__": _resolve_pct,
        "True": True,
        "False": False,
        "None": None,
    }
    try:
        return eval(_sub_refs(expr), env)  # noqa: S307 - trusted local config files
    except (NameError, SyntaxError) as e:
        raise ValueError(f"cannot parse config value {expr!r}: {e}") from e


def parse_binding(line: str) -> None:
    """Parse one ``target.param = value`` or ``MACRO = value`` binding."""
    lhs, _, rhs = line.partition("=")
    if not _:
        raise ValueError(f"not a binding: {line!r}")
    lhs = lhs.strip()
    value = parse_value(rhs)
    # gin scopes ("scope/target.param") are accepted and flattened.
    lhs = lhs.rsplit("/", 1)[-1]
    if "." in lhs:
        target, param = lhs.rsplit(".", 1)
        registry.bind(target, param, value)
    else:
        _MACROS[lhs] = value


def _logical_lines(text: str):
    """Yield logical lines, joining bracket continuations and stripping
    comments outside string literals."""
    buf = ""
    depth = 0
    for raw in text.splitlines():
        # Strip comments (a '#' outside quotes).
        line = ""
        in_str: str | None = None
        for ch in raw:
            if in_str:
                line += ch
                if ch == in_str:
                    in_str = None
            elif ch in "\"'":
                in_str = ch
                line += ch
            elif ch == "#":
                break
            else:
                line += ch
                if ch in "([{":
                    depth += 1
                elif ch in ")]}":
                    depth -= 1
        buf += line
        if depth > 0:
            buf += " "
            continue
        if buf.strip():
            yield buf.strip()
        buf = ""
    if buf.strip():
        yield buf.strip()


def parse_string(
    text: str,
    *,
    base_dir: str = ".",
    substitutions: dict[str, str] | None = None,
) -> None:
    for key, val in (substitutions or {}).items():
        text = text.replace("{%s}" % key, val)
    for line in _logical_lines(text):
        if line.startswith("include "):
            path = parse_value(line[len("include ") :])
            if not os.path.isabs(path):
                # Reference configs use repo-root-relative include paths
                # (e.g. include "config/base.gin"); fall back to the
                # including file's directory.
                for cand in (path, os.path.join(base_dir, path)):
                    if os.path.exists(cand):
                        path = cand
                        break
            parse_file(path, substitutions=substitutions)
        elif line.startswith("import "):
            import_port_module(line[len("import ") :].strip())
        else:
            parse_binding(line)


def import_port_module(name: str):
    """Import the port's counterpart of ``name`` (a config file's
    ``import`` line); a module the port lacks raises ImportError naming
    the ROADMAP item that ports it."""
    port = registry.port_name(name)
    try:
        return importlib.import_module(port)
    except ModuleNotFoundError as e:
        if not (e.name and (port == e.name or port.startswith(e.name + "."))):
            raise  # a module that exists failed on one of its own imports
        rest = port.split(".", 1)[1] if "." in port else port
        item = _ROADMAP_ITEM.get(rest, "no item yet: see ROADMAP.md queue A")
        raise ImportError(
            f"config imports {name}, whose port {port} does not exist yet; "
            f"ROADMAP {item} ports it"
        ) from e


def parse_file(path: str, *, substitutions: dict[str, str] | None = None) -> None:
    with open(path) as f:
        text = f.read()
    parse_string(
        text,
        base_dir=os.path.dirname(os.path.abspath(path)),
        substitutions=substitutions,
    )
