"""Typed, validated, JSON-serializable parameters for pipeline stages.

Capability parity with the reference param system
(``flink-ml-core/.../ml/param/Param.java:33-79``,
``WithParams.java:74-125``, ``ParamValidators.java``): a ``Param[T]`` carries
name / description / default / validator and knows how to encode itself to
JSON; ``WithParams`` provides get/set with validation and a param map.

Differences from the reference: params are plain Python descriptors discovered by
class-attribute scan (no reflection over getter interfaces), and values are
restricted to JSON-representable types so that stage metadata round-trips
losslessly between hosts. This module is a copy of the JAX package's
``flinkml_tpu.params``: the JSON param maps must stay byte-identical, because
the content fingerprint of a saved model hashes them
(:func:`flinkml_tpu_torch.io.read_write.content_fingerprint`).
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Generic, Optional, Sequence, TypeVar

T = TypeVar("T")


class ParamValidators:
    """Factory methods for common validators.

    Parity: ``ml/param/ParamValidators.java:27-`` (gt/gtEq/lt/ltEq/inRange/
    inArray/notNull), plus ``non_empty_array`` used by array-typed params.
    Each validator is a predicate ``value -> bool``.
    """

    @staticmethod
    def always_true() -> Callable[[Any], bool]:
        return lambda v: True

    @staticmethod
    def gt(lower: float) -> Callable[[Any], bool]:
        return lambda v: v is not None and v > lower

    @staticmethod
    def gt_eq(lower: float) -> Callable[[Any], bool]:
        return lambda v: v is not None and v >= lower

    @staticmethod
    def lt(upper: float) -> Callable[[Any], bool]:
        return lambda v: v is not None and v < upper

    @staticmethod
    def lt_eq(upper: float) -> Callable[[Any], bool]:
        return lambda v: v is not None and v <= upper

    @staticmethod
    def in_range(
        lower: float,
        upper: float,
        lower_inclusive: bool = True,
        upper_inclusive: bool = True,
    ) -> Callable[[Any], bool]:
        def check(v: Any) -> bool:
            if v is None:
                return False
            if not (lower <= v <= upper):
                return False
            if not lower_inclusive and v == lower:
                return False
            if not upper_inclusive and v == upper:
                return False
            return True

        return check

    @staticmethod
    def in_array(allowed: Sequence[Any]) -> Callable[[Any], bool]:
        allowed_set = list(allowed)
        return lambda v: v in allowed_set

    @staticmethod
    def not_null() -> Callable[[Any], bool]:
        return lambda v: v is not None

    @staticmethod
    def non_empty_array() -> Callable[[Any], bool]:
        return lambda v: v is not None and len(v) > 0


class Param(Generic[T]):
    """Definition of a stage parameter.

    Parity: ``ml/param/Param.java:33-79``. A ``Param`` is identified by name
    and owns JSON encode/decode of its value. Typed subclasses below mirror
    the reference's 14 typed subclasses where they change encode/decode or
    validation semantics.
    """

    def __init__(
        self,
        name: str,
        description: str = "",
        default_value: Optional[T] = None,
        validator: Optional[Callable[[Any], bool]] = None,
    ) -> None:
        self.name = name
        self.description = description
        self.validator = validator or ParamValidators.always_true()
        if default_value is not None and not self.validator(default_value):
            raise ValueError(
                f"Parameter {name} is given an invalid default value {default_value}"
            )
        self.default_value = default_value

    # -- JSON round-trip ---------------------------------------------------
    def json_encode(self, value: T) -> Any:
        return value

    def json_decode(self, json_value: Any) -> T:
        return json_value

    def validate(self, value: Any) -> None:
        if not self.validator(value):
            raise ValueError(f"Parameter {self.name} is given an invalid value {value}")

    def __repr__(self) -> str:  # pragma: no cover
        return f"{type(self).__name__}({self.name!r})"


class IntParam(Param[int]):
    def json_decode(self, json_value: Any) -> int:
        return int(json_value)


class LongParam(Param[int]):
    """64-bit integer param; Python ints are unbounded so this is IntParam."""

    def json_decode(self, json_value: Any) -> int:
        return int(json_value)


class FloatParam(Param[float]):
    def json_decode(self, json_value: Any) -> float:
        return float(json_value)


# Alias matching the reference's DoubleParam naming.
DoubleParam = FloatParam


class BoolParam(Param[bool]):
    def json_decode(self, json_value: Any) -> bool:
        return bool(json_value)


class StringParam(Param[str]):
    pass


class IntArrayParam(Param[list]):
    def json_encode(self, value: list) -> Any:
        return list(value) if value is not None else None

    def json_decode(self, json_value: Any) -> list:
        return [int(v) for v in json_value]


class FloatArrayParam(Param[list]):
    def json_encode(self, value: list) -> Any:
        return list(value) if value is not None else None

    def json_decode(self, json_value: Any) -> list:
        return [float(v) for v in json_value]


DoubleArrayParam = FloatArrayParam


class FloatArrayArrayParam(Param[list]):
    """List-of-float-lists (the reference's DoubleArrayArrayParam), e.g.
    per-column bucket split arrays."""

    def json_encode(self, value: list) -> Any:
        return [list(row) for row in value] if value is not None else None

    def json_decode(self, json_value: Any) -> list:
        return [[float(v) for v in row] for row in json_value]


DoubleArrayArrayParam = FloatArrayArrayParam


class StringArrayParam(Param[list]):
    def json_encode(self, value: list) -> Any:
        return list(value) if value is not None else None

    def json_decode(self, json_value: Any) -> list:
        return [str(v) for v in json_value]


class WithParams:
    """Mixin giving a class a validated parameter map.

    Parity: ``ml/param/WithParams.java:51-125``. ``Param`` definitions are
    class attributes; instance values live in ``self._param_map``. ``set``
    validates and returns ``self`` for chaining; ``get`` falls back to the
    param's default.

    Subclasses also get snake_case ``set_<name>`` / ``get_<name>`` sugar via
    ``__getattr__`` so user code reads naturally (the reference's Java
    mixins expose camelCase setters; the Python binding maps snake→camel at
    ``flink-ml-python/pyflink/ml/core/wrapper.py:39-83`` — here Python is the
    primary API so snake_case is native).
    """

    def __init__(self) -> None:
        self._param_map: dict[Param, Any] = {}

    # Per-class cache of discovered Param definitions; Params are static
    # class attributes so one MRO scan per class suffices.
    _params_by_class: dict = {}

    # -- core accessors ----------------------------------------------------
    @classmethod
    def params(cls) -> list:
        """All Param definitions on this class, in MRO discovery order."""
        return list(cls._param_index().values())

    @classmethod
    def _param_index(cls) -> dict:
        cached = WithParams._params_by_class.get(cls)
        if cached is None:
            cached = {}
            for klass in reversed(cls.__mro__):
                for attr in vars(klass).values():
                    if isinstance(attr, Param):
                        cached[attr.name] = attr
            WithParams._params_by_class[cls] = cached
        return cached

    @classmethod
    def get_param(cls, name: str) -> Optional[Param]:
        return cls._param_index().get(name)

    def set(self, param: Param, value: Any) -> "WithParams":
        # Re-key through this class's own Param of the same name, so values
        # set via an equal-but-distinct Param (e.g. copy_params_from across
        # stage types) land where this class's accessors find them.
        own = self.get_param(param.name)
        if own is None:
            raise ValueError(
                f"Parameter {param.name} is not defined on {type(self).__name__}"
            )
        own.validate(value)
        self._ensure_map()[own] = value
        return self

    def get(self, param: Param) -> Any:
        own = self.get_param(param.name)
        if own is None:
            raise ValueError(
                f"Parameter {param.name} is not defined on {type(self).__name__}"
            )
        m = self._ensure_map()
        if own in m:
            return m[own]
        return own.default_value

    @property
    def param_map(self) -> dict:
        """Live map of explicitly-set params (param -> value)."""
        return self._ensure_map()

    def _ensure_map(self) -> dict:
        if not hasattr(self, "_param_map"):
            self._param_map = {}
        return self._param_map

    # -- snake_case sugar --------------------------------------------------
    def __getattr__(self, item: str):
        # Only called when normal lookup fails.
        if item.startswith("set_"):
            param = self._lookup_snake(item[4:])
            if param is not None:
                return lambda value: self.set(param, value)
        elif item.startswith("get_"):
            param = self._lookup_snake(item[4:])
            if param is not None:
                return lambda: self.get(param)
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {item!r}"
        )

    @classmethod
    def _lookup_snake(cls, snake: str) -> Optional[Param]:
        camel = _snake_to_camel(snake)
        for p in cls.params():
            if p.name == camel or p.name == snake:
                return p
        return None

    # -- JSON round-trip ---------------------------------------------------
    def get_param_map_json(self) -> dict:
        """Encode the *effective* param map (defaults included) to JSON."""
        out = {}
        for p in self.params():
            out[p.name] = p.json_encode(self.get(p))
        return out

    def load_param_map_json(self, json_map: dict) -> "WithParams":
        for name, json_value in json_map.items():
            p = self.get_param(name)
            if p is None:
                # Unknown params are tolerated for forward compatibility.
                continue
            if json_value is None:
                continue
            self.set(p, p.json_decode(json_value))
        return self

    def copy_params_from(self, other: "WithParams") -> "WithParams":
        for p, v in other.param_map.items():
            if self.get_param(p.name) is not None:
                self.set(p, copy.deepcopy(v))
        return self


def _snake_to_camel(s: str) -> str:
    parts = s.split("_")
    return parts[0] + "".join(w.capitalize() for w in parts[1:])
