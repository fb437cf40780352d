"""``@sentinel_resource`` — function-level guard with handler dispatch.

Analog of the ``@SentinelResource`` annotation + aspect
(``sentinel-annotation-aspectj/.../SentinelResourceAspect.java:36-68``,
``AbstractSentinelAspectSupport.java:83-140``): the wrapped callable is the
resource; on block the ``block_handler`` runs; on a business exception the
error is traced and the ``fallback`` runs (unless the exception type is
ignored). The reference dispatches handlers by reflected method name — here
they are plain callables, and async callables get an async wrapper.
"""

from __future__ import annotations

import functools
import inspect
from typing import Callable, Optional, Tuple, Type

from sentinel_tpu_torch.local import BlockException, EntryType
from sentinel_tpu_torch.local.sph import entry as _entry


def sentinel_resource(
    resource: Optional[str] = None,
    entry_type: EntryType = EntryType.OUT,
    block_handler: Optional[Callable] = None,
    fallback: Optional[Callable] = None,
    exceptions_to_ignore: Tuple[Type[BaseException], ...] = (),
    args_as_params: bool = False,
):
    """Guard a function as a sentinel resource.

    - ``resource``: resource name; defaults to the function's qualified name
      (the aspect's ``getResourceName`` fallback).
    - ``block_handler(*args, ex=BlockException, **kwargs)``: runs on block.
    - ``fallback(*args, ex=Exception, **kwargs)``: runs on business error
      (after tracing), and on block when no ``block_handler`` is given —
      the reference's degrade-to-fallback order
      (``AbstractSentinelAspectSupport.handleBlockException``).
    - ``exceptions_to_ignore``: business exceptions re-raised untraced.
    - ``args_as_params``: pass the call's positional args to the slot chain
      so hot-param (``ParamFlowRule``) rules see them.
    """

    def decorate(fn: Callable) -> Callable:
        name = resource or f"{fn.__module__}.{fn.__qualname__}"

        def on_block(e, args, kwargs):
            if block_handler is not None:
                return block_handler(*args, ex=e, **kwargs)
            if fallback is not None:
                return fallback(*args, ex=e, **kwargs)
            raise e

        def on_error(e, args, kwargs):
            if isinstance(e, exceptions_to_ignore):
                raise e
            if fallback is not None:
                return fallback(*args, ex=e, **kwargs)
            raise e

        if inspect.iscoroutinefunction(fn):

            async def _maybe_await(value):
                # handlers may themselves be async — await their result
                return await value if inspect.isawaitable(value) else value

            @functools.wraps(fn)
            async def async_wrapper(*args, **kwargs):
                try:
                    e = _entry(
                        name, entry_type,
                        args=tuple(args) if args_as_params else (),
                    )
                except BlockException as be:
                    return await _maybe_await(on_block(be, args, kwargs))
                try:
                    return await fn(*args, **kwargs)
                except BaseException as err:
                    if not isinstance(err, exceptions_to_ignore):
                        e.trace(err)
                    return await _maybe_await(on_error(err, args, kwargs))
                finally:
                    e.exit()

            async_wrapper.__sentinel_resource__ = name
            return async_wrapper

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            try:
                e = _entry(
                    name, entry_type,
                    args=tuple(args) if args_as_params else (),
                )
            except BlockException as be:
                return on_block(be, args, kwargs)
            try:
                return fn(*args, **kwargs)
            except BaseException as err:
                if not isinstance(err, exceptions_to_ignore):
                    e.trace(err)
                return on_error(err, args, kwargs)
            finally:
                e.exit()

        wrapper.__sentinel_resource__ = name
        return wrapper

    return decorate


def sentinel_intercept(
    include: Optional[Callable[[str], bool]] = None,
    exclude: Tuple[str, ...] = (),
    resource_fmt: str = "{cls}.{method}",
    **resource_kwargs,
):
    """Class-level interceptor: guard every public method of a class.

    Analog of the CDI interceptor binding
    (``sentinel-annotation-cdi-interceptor/.../SentinelResourceInterceptor.java:35-70``,
    ``SentinelResourceBinding.java``): where CDI weaves an ``@AroundInvoke``
    interceptor around every business method of a bound bean, Python's
    idiom is a class decorator that wraps the class's own public methods
    with :func:`sentinel_resource`. Semantics match the reference:

    - every public method defined ON the class becomes a resource named
      ``resource_fmt.format(cls=..., method=...)``;
    - a method already bound with ``@sentinel_resource`` keeps its own
      binding (method-level annotation wins over the class binding — the
      CDI interceptor consults the method annotation first);
    - dunders, private methods (``_``-prefixed), static/class methods'
      descriptors, and non-callables are left alone;
    - ``include(name) -> bool`` / ``exclude`` narrow the set;
    - ``resource_kwargs`` (block_handler, fallback, entry_type, …) apply
      to every bound method, like binding-level defaults.

    Usage::

        @sentinel_intercept(fallback=my_fallback)
        class CheckoutService:
            def checkout(self, order): ...
            def refund(self, order): ...
    """

    def decorate(cls):
        def bind(fn: Callable, attr: str) -> Callable:
            return sentinel_resource(
                resource=resource_fmt.format(cls=cls.__name__, method=attr),
                **resource_kwargs,
            )(fn)

        for attr, member in list(vars(cls).items()):
            if attr.startswith("_") or attr in exclude:
                continue
            if include is not None and not include(attr):
                continue
            if isinstance(member, (staticmethod, classmethod)):
                inner = member.__func__
                if getattr(inner, "__sentinel_resource__", None):
                    continue
                setattr(cls, attr, type(member)(bind(inner, attr)))
                continue
            # plain FUNCTIONS only: nested classes and callable instances
            # are also callable, but wrapping them would corrupt them (a
            # function wrapper is a descriptor — it would bind self and
            # break isinstance/subclassing). The CDI interceptor likewise
            # wraps business METHODS, nothing else.
            if not inspect.isfunction(member):
                continue
            if getattr(member, "__sentinel_resource__", None):
                continue  # method-level @sentinel_resource wins
            setattr(cls, attr, bind(member, attr))
        return cls

    return decorate
