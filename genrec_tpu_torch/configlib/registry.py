"""Configurable registry: the ``@configurable`` decorator and binding store.

Semantics follow gin: a binding ``target.param = value`` supplies the value
of ``param`` whenever the configurable ``target`` is called *without* an
explicit ``param`` argument. Explicit call-site arguments always win.

Binding resolution is gin's module-path suffix rule (reference
genrec/modules/utils.py:85-117 drives six different ``train()`` functions
from one gin file this way): a binding target matches a configurable when
it equals, or is a trailing dot-delimited suffix of, the configurable's
canonical ``module.qualname`` path.  ``train.epochs = 3`` therefore applies
to *every* imported ``train`` configurable, while
``tiger_trainer.train.epochs = 3`` applies only to TIGER's; when several
bindings supply the same parameter the most specific target (most dot
components) wins, later bindings breaking ties.  This is what lets one
process import many trainers (pipelines.py) while shipped configs keep
writing plain ``train.x = y``.

The config files name the JAX package (``import genrec_tpu.models.rqvae``,
``%genrec_tpu.models.rqvae.QuantizeForwardMode.STE``). Every dotted name
that starts with ``genrec_tpu.`` is read as its counterpart under
``genrec_tpu_torch.`` (``port_name``): in import lines, binding targets,
``@`` references and ``%`` enum constants. Nothing here or in the parser
imports a ``genrec_tpu`` module.
"""

from __future__ import annotations

import enum
import functools
import inspect
import threading
from typing import Any, Callable

_LOCK = threading.RLock()

# canonical "module.qualname" -> wrapped callable.
_REGISTRY: dict[str, Callable] = {}

# short/leaf name -> set of canonical paths claiming it (for @Name lookup).
_SHORT: dict[str, set[str]] = {}

# (target string as written, param) -> value. Insertion-ordered; later
# bindings win among equally specific targets.
_BINDINGS: dict[tuple[str, str], Any] = {}

# dotted path -> enum class, for %module.Enum.MEMBER constants.
_ENUMS: dict[str, type[enum.Enum]] = {}


_JAX_PACKAGE, _PORT_PACKAGE = "genrec_tpu", "genrec_tpu_torch"


def port_name(dotted: str) -> str:
    """``genrec_tpu.<rest>`` -> ``genrec_tpu_torch.<rest>``; any other name
    unchanged (``genrec_tpu_torch.x`` included)."""
    if dotted == _JAX_PACKAGE or dotted.startswith(_JAX_PACKAGE + "."):
        return _PORT_PACKAGE + dotted[len(_JAX_PACKAGE):]
    return dotted


class Ref:
    """Base for lazily-resolved config values (resolved at injection time)."""

    def resolve(self):  # pragma: no cover - abstract
        raise NotImplementedError


class ConfigurableRef(Ref):
    """A ``@Name`` value in a config file: resolves lazily to the callable."""

    def __init__(self, name: str, evaluate: bool = False):
        # gin scopes ("@scope/Name") are accepted and flattened, matching
        # the LHS treatment in the parser.
        self.name = port_name(name.rsplit("/", 1)[-1])
        self.evaluate = evaluate

    def resolve(self):
        fn = lookup(self.name)
        if fn is None:
            raise KeyError(f"@{self.name} does not name a registered configurable")
        return fn() if self.evaluate else fn

    def __repr__(self):
        return f"ConfigurableRef(@{self.name}{'()' if self.evaluate else ''})"

    def __eq__(self, other):
        return (
            isinstance(other, ConfigurableRef)
            and other.name == self.name
            and other.evaluate == self.evaluate
        )

    def __hash__(self):
        return hash((self.name, self.evaluate))


def _paths_for(fn: Callable, name: str | None) -> tuple[str, ...]:
    """Every dotted path the configurable answers to: the canonical
    ``module.qualname`` and, for a custom registration name, the same path
    with the leaf swapped for that name."""
    full = f"{fn.__module__}.{fn.__qualname__}"
    if name and name != fn.__name__:
        return (full, f"{fn.__module__}.{name}")
    return (full,)


def _matches(target: str, path: str) -> bool:
    """gin suffix rule: target matches path when equal or a trailing
    dot-component suffix."""
    return path == target or path.endswith("." + target)


def configurable(fn_or_name: Callable | str | None = None, *, name: str | None = None):
    """Register a function or class so config bindings apply to its calls.

    Usable as ``@configurable``, ``@configurable("other_name")`` or
    ``@configurable(name="other_name")``.
    """
    if isinstance(fn_or_name, str):
        return functools.partial(configurable, name=fn_or_name)
    if fn_or_name is None:
        return functools.partial(configurable, name=name)

    fn = fn_or_name
    paths = _paths_for(fn, name)

    if inspect.isclass(fn):
        sig = inspect.signature(fn.__init__)
        sig = sig.replace(parameters=list(sig.parameters.values())[1:])  # drop self
        wrapped = _wrap_class(fn, paths)
    else:
        sig = inspect.signature(fn)
        wrapped = _wrap_function(fn, paths)

    wrapped.__signature__ = sig  # type: ignore[attr-defined]
    with _LOCK:
        for p in paths:
            _REGISTRY[p] = wrapped
            _SHORT.setdefault(p.rsplit(".", 1)[-1], set()).add(p)
    return wrapped


def _positional_params(fn: Callable) -> list[str]:
    """Names of parameters that can be filled positionally, in order
    (POSITIONAL_ONLY / POSITIONAL_OR_KEYWORD, minus self)."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return []
    return [
        p.name
        for p in sig.parameters.values()
        if p.name != "self"
        and p.kind
        in (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)
    ]


def _effective_bindings(paths: tuple[str, ...]) -> dict[str, Any]:
    """Bindings applying to a configurable answering to ``paths``, resolved
    by most-specific-suffix (ties: later binding wins)."""
    with _LOCK:
        picked: dict[str, tuple[int, Any]] = {}
        for (target, param), value in _BINDINGS.items():
            if not any(_matches(target, p) for p in paths):
                continue
            spec = target.count(".")
            # >= : equal specificity resolves to the later binding.
            if param not in picked or spec >= picked[param][0]:
                picked[param] = (spec, value)
    return {p: v for p, (_, v) in picked.items()}


def _merge_kwargs(
    paths: tuple[str, ...], pos_params: list[str], args: tuple, kwargs: dict
) -> dict:
    """Compute binding-supplied kwargs not covered by explicit arguments."""
    bound = _effective_bindings(paths)
    if not bound:
        return kwargs
    # Parameters consumed positionally cannot also come from bindings.
    positional = set(pos_params[: len(args)])
    merged = dict(kwargs)
    for p, v in bound.items():
        if p in merged or p in positional:
            continue
        merged[p] = _materialize(v)
    return merged


def _materialize(value):
    """Resolve lazy Refs (incl. nested inside containers)."""
    if isinstance(value, Ref):
        return value.resolve()
    if isinstance(value, list):
        return [_materialize(v) for v in value]
    if isinstance(value, tuple):
        return tuple(_materialize(v) for v in value)
    if isinstance(value, dict):
        return {k: _materialize(v) for k, v in value.items()}
    return value


def _wrap_function(fn: Callable, paths: tuple[str, ...]) -> Callable:
    pos_params = _positional_params(fn)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        return fn(*args, **_merge_kwargs(paths, pos_params, args, kwargs))

    wrapper.__gin_name__ = paths[0]  # type: ignore[attr-defined]
    return wrapper


def _wrap_class(cls: type, paths: tuple[str, ...]) -> type:
    orig_init = cls.__init__
    pos_params = _positional_params(orig_init)

    @functools.wraps(orig_init)
    def __init__(self, *args, **kwargs):
        orig_init(self, *args, **_merge_kwargs(paths, pos_params, args, kwargs))

    cls.__init__ = __init__
    cls.__gin_name__ = paths[0]  # type: ignore[attr-defined]
    return cls


def register_enum(cls: type[enum.Enum]) -> type[enum.Enum]:
    """Register an enum for ``%module.Enum.MEMBER`` constants (gin's
    ``constants_from_enum``, reference rqvae.py:43-51)."""
    path = f"{cls.__module__}.{cls.__qualname__}"
    with _LOCK:
        _ENUMS[path] = cls
        _ENUMS[cls.__qualname__] = cls
    return cls


def resolve_enum(dotted: str):
    """Resolve ``pkg.module.Enum.MEMBER`` to the enum member, or None.

    A ``genrec_tpu.`` path names the port's module (``port_name``); an
    enum not registered yet is looked up by importing that port module,
    never the JAX one."""
    if "." not in dotted:
        return None
    path, member = port_name(dotted).rsplit(".", 1)
    with _LOCK:
        cls = _ENUMS.get(path) or _ENUMS.get(path.rsplit(".", 1)[-1])
    if cls is None:
        mod_path, _, cls_name = path.rpartition(".")
        if mod_path.startswith(_PORT_PACKAGE + "."):
            try:
                import importlib

                mod = importlib.import_module(mod_path)
                cls = getattr(mod, cls_name, None)
            except ImportError:
                cls = None
    if cls is not None and isinstance(cls, type) and issubclass(cls, enum.Enum):
        return cls[member]
    return None


def lookup(name: str) -> Callable | None:
    """Resolve a configurable by path suffix.

    Exact canonical paths hit directly; otherwise the dotted suffix must
    identify exactly ONE registered configurable — `@train` with two
    trainer modules imported is an error (gin's ambiguity rule applies to
    *references*, which need a single callable, not to bindings)."""
    name = port_name(name)
    with _LOCK:
        if name in _REGISTRY:
            return _REGISTRY[name]
        leaf = name.rsplit(".", 1)[-1]
        cands = sorted(p for p in _SHORT.get(leaf, ()) if _matches(name, p))
        if not cands:
            return None
        distinct = {id(_REGISTRY[p]) for p in cands}
        if len(distinct) > 1:
            raise KeyError(
                f"{name!r} is ambiguous — it suffix-matches {cands}; "
                "use a longer module-path suffix"
            )
        return _REGISTRY[cands[0]]


def bind(target: str, param: str, value: Any) -> None:
    """Store a binding under its literal target; resolution against
    configurables happens lazily at call time (suffix rule), so binding an
    ambiguous or not-yet-imported name is legal, exactly as in gin files
    parsed before their imports. A ``genrec_tpu.`` target binds the
    port's counterpart."""
    target = port_name(target)
    with _LOCK:
        # Re-insert so "later binding wins" holds for repeated targets.
        _BINDINGS.pop((target, param), None)
        _BINDINGS[(target, param)] = value


def get_binding(target: str, param: str, default: Any = None) -> Any:
    """The value ``param`` would receive if the configurable named by
    ``target`` were called now (suffix resolution included)."""
    target = port_name(target)
    with _LOCK:
        paths = [p for ps in _SHORT.values() for p in ps if _matches(target, p)]
    if not paths:
        # Target not imported/registered: fall back to literal-target scan
        # so bindings can be queried before their module exists.
        paths = [target]
    eff = _effective_bindings(tuple(dict.fromkeys(paths)))
    if param in eff:
        return _materialize(eff[param])
    return default


def get_bindings(target: str) -> dict[str, Any]:
    target = port_name(target)
    with _LOCK:
        paths = [p for ps in _SHORT.values() for p in ps if _matches(target, p)]
    if not paths:
        paths = [target]
    return {
        p: _materialize(v)
        for p, v in _effective_bindings(tuple(dict.fromkeys(paths))).items()
    }


def query(target_dot_param: str, default: Any = None) -> Any:
    target, _, param = target_dot_param.rpartition(".")
    return get_binding(target, param, default)


def clear_bindings() -> None:
    with _LOCK:
        _BINDINGS.clear()
