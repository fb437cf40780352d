"""gRPC server + client interceptors (``sentinel-grpc-adapter`` analog).

Reference: ``SentinelGrpcServerInterceptor.java`` /
``SentinelGrpcClientInterceptor.java`` — resource is the full method name;
server blocks map to RESOURCE_EXHAUSTED; client guards the outbound call as
an OUT-type resource. Needs ``grpcio``: importing this module without it
raises ``ImportError``.
"""

from __future__ import annotations

import grpc

from sentinel_tpu_torch.local import BlockException, EntryType
from sentinel_tpu_torch.local import context as _ctx
from sentinel_tpu_torch.local.sph import async_entry as _async_entry
from sentinel_tpu_torch.local.sph import entry as _entry

BLOCK_MSG = "Blocked by Sentinel (flow limiting)"


class SentinelServerInterceptor(grpc.ServerInterceptor):
    """Guard every unary/streaming handler by its full method name."""

    def __init__(self, origin_metadata_key: str = "sentinel-origin"):
        self._origin_key = origin_metadata_key

    def intercept_service(self, continuation, handler_call_details):
        handler = continuation(handler_call_details)
        if handler is None:
            return None
        resource = handler_call_details.method
        origin = ""
        for key, value in handler_call_details.invocation_metadata or ():
            if key == self._origin_key:
                origin = value
                break

        def guard(behavior, request_streaming, response_streaming):
            def guarded(request_or_iterator, servicer_context):
                _ctx.enter(name=f"grpc_context:{resource}", origin=origin)
                try:
                    try:
                        entry = _entry(resource, EntryType.IN)
                    except BlockException:
                        servicer_context.abort(
                            grpc.StatusCode.RESOURCE_EXHAUSTED, BLOCK_MSG
                        )
                        return  # pragma: no cover - abort raises
                    try:
                        return behavior(request_or_iterator, servicer_context)
                    except BaseException as err:
                        entry.trace(err)
                        raise
                    finally:
                        entry.exit()
                finally:
                    _ctx.exit()

            return guarded

        return _wrap_handler(handler, guard)

def _wrap_handler(handler, guard):
    if handler.unary_unary:
        return grpc.unary_unary_rpc_method_handler(
            guard(handler.unary_unary, False, False),
            request_deserializer=handler.request_deserializer,
            response_serializer=handler.response_serializer,
        )
    if handler.unary_stream:
        return grpc.unary_stream_rpc_method_handler(
            guard(handler.unary_stream, False, True),
            request_deserializer=handler.request_deserializer,
            response_serializer=handler.response_serializer,
        )
    if handler.stream_unary:
        return grpc.stream_unary_rpc_method_handler(
            guard(handler.stream_unary, True, False),
            request_deserializer=handler.request_deserializer,
            response_serializer=handler.response_serializer,
        )
    return grpc.stream_stream_rpc_method_handler(
        guard(handler.stream_stream, True, True),
        request_deserializer=handler.request_deserializer,
        response_serializer=handler.response_serializer,
    )

class SentinelClientInterceptor(
    grpc.UnaryUnaryClientInterceptor, grpc.UnaryStreamClientInterceptor
):
    """Guard outbound calls; a block raises ``BlockException`` to the
    caller before any network I/O (the reference fails the call with
    UNAVAILABLE — raising keeps the local API uniform). The guard is a
    detached ``async_entry``: the done-callback may fire on a channel
    thread, out of order with other in-flight RPCs from the same caller,
    without corrupting the caller's entry stack — RT/error stats still
    cover the real call duration."""

    def _intercept(self, continuation, client_call_details, request):
        e = _async_entry(client_call_details.method, EntryType.OUT)
        try:
            call = continuation(client_call_details, request)
        except BaseException as err:
            e.trace(err)
            e.exit()
            raise

        def on_done(completed):
            try:
                exc = completed.exception()
            except BaseException:
                exc = None  # cancelled
            if exc is not None:
                e.trace(exc)
            e.exit()

        call.add_done_callback(on_done)
        return call

    def intercept_unary_unary(self, continuation, client_call_details, request):
        return self._intercept(continuation, client_call_details, request)

    def intercept_unary_stream(self, continuation, client_call_details, request):
        return self._intercept(continuation, client_call_details, request)
