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
"""

from __future__ import annotations

import os
from typing import Optional

from tpu_composer_torch.fabric.inmem import InMemoryPool
from tpu_composer_torch.fabric.provider import FabricProvider
from tpu_composer_torch.runtime import tracing

_shared_mock: Optional[InMemoryPool] = None


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
    tracing at all). Wraps by delegation, so it composes
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
    if kind in ("REST_CM", "REST_FM", "LAYOUT", "REDFISH"):
        endpoint = os.environ.get("FABRIC_ENDPOINT", "")
        if not endpoint:
            raise AdapterError(f"{kind} requires FABRIC_ENDPOINT")
        try:
            if kind in ("REST_CM", "REST_FM"):
                from tpu_composer_torch.fabric.rest import RestPoolClient

                client: FabricProvider = RestPoolClient(
                    endpoint=endpoint,
                    tenant_id=os.environ.get("FABRIC_TENANT_ID", ""),
                    cluster_id=os.environ.get("FABRIC_CLUSTER_ID", ""),
                    synchronous=(kind == "REST_FM"),
                )
            elif kind == "LAYOUT":
                from tpu_composer_torch.fabric.layout import LayoutApplyClient

                client = LayoutApplyClient(endpoint=endpoint)
            else:
                from tpu_composer_torch.fabric.redfish import RedfishClient

                client = RedfishClient(endpoint=endpoint)
        except ModuleNotFoundError as e:
            raise AdapterError(f"{kind} backend not available: {e}") from e
        return _wrap_breaker(client, endpoint)
    raise AdapterError(f"unknown CDI_PROVIDER_TYPE {kind!r}")


def _wrap_breaker(client: FabricProvider, endpoint: str) -> FabricProvider:
    """Every remote provider ships behind a per-endpoint circuit breaker
    TPU_COMPOSER_BREAKER=0 opts out; threshold/reset
    are env-tunable for known-flaky fabrics."""
    if os.environ.get("TPU_COMPOSER_BREAKER", "1") == "0":
        return client
    from tpu_composer_torch.fabric.breaker import BreakerConfig, BreakerFabricProvider

    config = BreakerConfig()
    try:
        config.failure_threshold = int(
            os.environ.get("TPU_COMPOSER_BREAKER_THRESHOLD",
                           config.failure_threshold)
        )
        config.reset_timeout = float(
            os.environ.get("TPU_COMPOSER_BREAKER_RESET_S", config.reset_timeout)
        )
    except ValueError as e:
        raise AdapterError(f"bad breaker env override: {e}") from e
    return BreakerFabricProvider(client, endpoint=endpoint, config=config)


def reset_shared_mock() -> None:
    """Test hook: drop the shared mock pool."""
    global _shared_mock
    _shared_mock = None
