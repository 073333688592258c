"""Configuration knobs: one resolver for "which value does this call
site get?", most specific first:

  1. an **explicit argument** at the call site;
  2. the knob's **scope** context manager;
  3. the knob's **environment variable** (``REPRO_*``);
  4. the **default**.

The port's own copy of the machinery in ``repro.configs.knobs``, as far
as the knobs ported so far need it: the density-switch threshold
(``repro_torch.core.compose.DENSE_THRESHOLD``). Choice knobs and the
backend-dependent defaults come with the knobs that use them (ROADMAP).
"""
from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, Optional, Sequence


class Knob:
    """One configuration knob: explicit > scope > env > default.

    Args:
      name: the knob's canonical name.
      env: environment variable consulted at step 3 (an empty value is
        unset).
      default: the fallback value.
      parse: maps the env string to a value.
      coerce: normalizes explicit and scope values (e.g. ``float``).
      choices: optional closed value set; anything outside it raises.
      describe: the noun of the rejection message (default ``name``).
    """

    def __init__(self, name: str, *, env: Optional[str] = None,
                 default: Any = None,
                 parse: Callable[[str], Any] = lambda text: text,
                 coerce: Callable[[Any], Any] = lambda value: value,
                 choices: Optional[Sequence] = None,
                 describe: Optional[str] = None):
        self.name = name
        self.env = env
        self.default = default
        self.parse = parse
        self.coerce = coerce
        self.choices = None if choices is None else tuple(choices)
        self.describe = name if describe is None else describe
        self._override: Any = None

    def check(self, value):
        if self.choices is not None and value not in self.choices:
            raise ValueError(
                f"unknown {self.describe} {value!r} (one of {self.choices})")
        return value

    def resolve(self, value: Any = None):
        """The knob's value for a call site (see the module ladder)."""
        if value is not None:
            return self.check(self.coerce(value))
        if self._override is not None:
            return self._override
        env = os.environ.get(self.env) if self.env else None
        if env:
            return self.check(self.parse(env))
        return self.check(self.coerce(self.default))

    @contextlib.contextmanager
    def scope(self, value: Any):
        """Pin the knob for everything resolved under the scope (None
        clears an outer override back to env/default). Scopes nest; each
        restores the previous override on exit."""
        prev = self._override
        self._override = None if value is None else self.resolve(value)
        try:
            yield
        finally:
            self._override = prev
