"""Package exports resolved at first use, so importing one module of a
package does not import all the others (the CLI's start-up imports only what
its subcommand needs)."""

from __future__ import annotations

import importlib


def lazy_exports(package: str, exports: dict[str, tuple[str, ...]], submodules: tuple[str, ...] = ()):
    """``(__all__, __getattr__, __dir__)`` for ``package``'s ``__init__``:
    ``exports`` maps a module (relative to the package) to the names it
    gives; ``submodules`` are exported as modules."""
    module_of = {name: module for module, names in exports.items() for name in names}
    names = sorted([*submodules, *module_of])

    def __getattr__(name: str):
        if name in submodules:
            return importlib.import_module(f"{package}.{name}")
        if name not in module_of:
            raise AttributeError(f"module '{package}' has no attribute '{name}'")
        value = getattr(importlib.import_module(f"{package}.{module_of[name]}"), name)
        setattr(importlib.import_module(package), name, value)
        return value

    def __dir__():
        return sorted(set(vars(importlib.import_module(package))) | set(names))

    return names, __getattr__, __dir__
