"""Env-driven fabric provider factory (port of
``tpu_composer/fabric/adapter.py``).

Reference analog: NewComposableResourceAdapter
(internal/controller/composableresource_adapter.go:40-76) — selects among
SUNFISH | NEC | FTI_CDI (CM/FM) via CDI_PROVIDER_TYPE / FTI_CDI_API_TYPE env
vars. Same pattern, TPU backends:

    CDI_PROVIDER_TYPE = MOCK        -> InMemoryPool (default)
                        REST_CM     -> async REST pool client (CM-style)
                        REST_FM     -> sync REST pool client (FM-style)
                        LAYOUT      -> layout-apply pool client (NEC-style)
                        REDFISH     -> redfish-style client (Sunfish-style)

The port serves MOCK. The remote backends (and the circuit breaker every
remote backend ships behind) arrive with the fabric I/O sub-slice; until
then naming one raises :class:`AdapterError`, with no fallback to the
mock.
"""

from __future__ import annotations

import os
from typing import Optional

from tpu_composer_torch.fabric.inmem import InMemoryPool
from tpu_composer_torch.fabric.provider import FabricProvider
from tpu_composer_torch.runtime import tracing

_shared_mock: Optional[InMemoryPool] = None


#: The JAX package's remote backends, which the port does not have yet.
REMOTE_BACKENDS = ("REST_CM", "REST_FM", "LAYOUT", "REDFISH")


class AdapterError(ValueError):
    pass


_TRACED_METHODS = (
    "add_resource", "remove_resource", "check_resource", "get_resources",
    "add_resources", "remove_resources",
    "reserve_slice", "release_slice", "resize_slice", "repair_slice_member",
)


class TracedFabricProvider:
    """Transparent tracing wrapper: every fabric verb becomes a span, so a
    slow attach shows WHICH fabric call ate the time (the reference has no
    tracing at all — SURVEY.md §5). Wraps by delegation, so it composes
    with any provider including ones defining only the base-class
    resize_slice default.

    Wrapped verbs are built once and cached in the instance __dict__:
    ``__getattr__`` only fires on a miss, so after the first access each
    fabric verb is a plain attribute read — the hot attach path no longer
    pays a delegation lookup plus a closure allocation per call."""

    def __init__(self, inner: FabricProvider) -> None:
        self._inner = inner

    def __getattr__(self, name: str):
        attr = getattr(self._inner, name)
        if name in _TRACED_METHODS and callable(attr):
            provider = type(self._inner).__name__

            group_verb = name in ("add_resources", "remove_resources")

            def traced(*args, **kwargs):
                extra = {}
                if group_verb and args:
                    # Group calls carry their fan-out so the trace shows
                    # how many members one wire call amortized.
                    try:
                        extra["members"] = len(args[0])
                    except TypeError:
                        pass
                with tracing.span(f"fabric.{name}", cat="fabric",
                                  provider=provider, **extra):
                    return attr(*args, **kwargs)

            # Only verb wrappers are cached — other attributes (test-pool
            # counters, injection knobs) stay live reads on the inner.
            self.__dict__[name] = traced
            return traced
        return attr


def new_fabric_provider(provider_type: Optional[str] = None) -> FabricProvider:
    """Build the provider named by `provider_type` or $CDI_PROVIDER_TYPE.

    The MOCK pool is process-shared: every controller must see the same
    inventory, the way all reference controllers share one fabric
    (composableresource_adapter.go is instantiated per reconcile but the
    fabric state lives server-side).
    """
    kind = (provider_type or os.environ.get("CDI_PROVIDER_TYPE", "MOCK")).upper()
    if kind == "MOCK":
        global _shared_mock
        if _shared_mock is None:
            _shared_mock = InMemoryPool(
                async_steps=int(os.environ.get("MOCK_FABRIC_ASYNC_STEPS", "0"))
            )
        return _shared_mock
    if kind in REMOTE_BACKENDS:
        raise AdapterError(
            f"CDI_PROVIDER_TYPE {kind} is not ported yet: the port serves"
            " MOCK only"
        )
    raise AdapterError(f"unknown CDI_PROVIDER_TYPE {kind!r}")


def reset_shared_mock() -> None:
    """Test hook: drop the shared mock pool."""
    global _shared_mock
    _shared_mock = None
