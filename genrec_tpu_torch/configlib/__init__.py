"""Self-contained gin-compatible configuration system (copy of
genrec_tpu/configlib, so that one config file drives both packages).

The reference drives every trainer through gin-config files
(``config/*.gin`` + ``parse_config()``, reference genrec/modules/utils.py:85-117).
gin itself is torch-free but not available in this environment, so the
framework ships its own implementation of the subset of gin the reference
configs use (see config/*.gin in the reference repo):

- ``target.param = value`` bindings injected as defaults into
  ``@configurable`` callables
- Python-literal values (numbers, strings, bools, lists, dicts, tuples)
- ``MACRO = value`` definitions and ``%MACRO`` references
- ``%dotted.path.Enum.MEMBER`` enum constants
- ``@Name`` configurable references and ``@Name()`` evaluated references
- ``include "path"`` and ``import module`` statements
- ``{split}`` textual placeholder substitution before parsing
- ``--gin "k=v"`` command-line override bindings
"""

from genrec_tpu_torch.configlib.registry import (
    configurable,
    bind,
    clear_bindings,
    get_binding,
    get_bindings,
    query,
    register_enum,
)
from genrec_tpu_torch.configlib.parser import (
    parse_file,
    parse_string,
    parse_binding,
    clear_macros,
)
from genrec_tpu_torch.configlib.cli import parse_config

__all__ = [
    "configurable",
    "bind",
    "clear_bindings",
    "get_binding",
    "get_bindings",
    "query",
    "register_enum",
    "parse_file",
    "parse_string",
    "parse_binding",
    "parse_config",
    "clear_macros",
]
