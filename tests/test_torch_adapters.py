"""The port's adapters (``sentinel_tpu_torch.adapters``) on the CPU.

The reference's ``tests/test_adapters.py`` and
``tests/test_adapters_async_web.py``, case for case, rerun against the
port's copies: decorator, class interceptor, WSGI, ASGI, gateway rules and
API definitions, gRPC interceptors, the ``requests``/``httpx`` guards,
origin propagation, the aiohttp middleware and the Tornado mixin. Each case
runs on the port's ``ManualClock`` (the suite's fixture installs the JAX
package's). The framework cases need ``grpcio``, ``httpx``, ``requests``,
``aiohttp`` and ``tornado`` and skip without them, as the reference's do.
"""

import asyncio
import json

import pytest

pytest.importorskip("torch")

import torch_parity  # noqa: E402,F401  (stat logs to a temp dir)
import sentinel_tpu_torch.local as sentinel  # noqa: E402
from sentinel_tpu_torch.adapters import (  # noqa: E402
    GatewayFlowRule,
    GatewayParamFlowItem,
    GatewayRuleManager,
    MatchStrategy,
    ParseStrategy,
    SentinelAsgiMiddleware,
    SentinelWsgiMiddleware,
    sentinel_resource,
)
from sentinel_tpu_torch.adapters.gateway import (  # noqa: E402
    ABSENT,
    NOT_MATCH,
    DictRequestAdapter,
    ResourceMode,
)
from sentinel_tpu_torch.core import clock as t_clock  # noqa: E402
from sentinel_tpu_torch.local import (  # noqa: E402
    BlockException,
    FlowRule,
    FlowRuleManager,
)
from sentinel_tpu_torch.local.chain import cluster_node_map  # noqa: E402


@pytest.fixture
def manual_clock():
    """The port's ``ManualClock`` (the suite's fixture installs the JAX
    package's)."""
    mc = t_clock.ManualClock()
    prev = t_clock.set_clock(mc)
    yield mc
    t_clock.set_clock(prev)


@pytest.fixture(autouse=True)
def clean(manual_clock):
    sentinel.reset_for_tests()
    GatewayRuleManager.reset_for_tests()
    yield manual_clock
    GatewayRuleManager.reset_for_tests()
    sentinel.reset_for_tests()


class TestDecorator:
    def test_guards_and_blocks(self, manual_clock):
        calls = []

        @sentinel_resource("deco_res")
        def fn(x):
            calls.append(x)
            return x * 2

        FlowRuleManager.load_rules([FlowRule(resource="deco_res", count=2)])
        assert fn(1) == 2 and fn(2) == 4
        with pytest.raises(BlockException):
            fn(3)
        assert calls == [1, 2]

    def test_block_handler(self, manual_clock):
        @sentinel_resource("deco_bh", block_handler=lambda x, ex: f"blocked:{x}")
        def fn(x):
            return x

        FlowRuleManager.load_rules([FlowRule(resource="deco_bh", count=1)])
        assert fn("a") == "a"
        assert fn("b") == "blocked:b"

    def test_fallback_on_error_and_trace(self, manual_clock):
        @sentinel_resource("deco_fb", fallback=lambda ex: "fell back")
        def fn():
            raise ValueError("boom")

        assert fn() == "fell back"
        from sentinel_tpu_torch.local.chain import cluster_node_map

        node = cluster_node_map()["deco_fb"]
        assert node.exception_qps(manual_clock.now_ms()) > 0

    def test_fallback_used_for_block_when_no_block_handler(self, manual_clock):
        @sentinel_resource("deco_fb2", fallback=lambda ex: "fb")
        def fn():
            return "ok"

        FlowRuleManager.load_rules([FlowRule(resource="deco_fb2", count=1)])
        assert fn() == "ok"
        assert fn() == "fb"

    def test_ignored_exceptions_not_traced(self, manual_clock):
        @sentinel_resource("deco_ig", exceptions_to_ignore=(KeyError,))
        def fn():
            raise KeyError("skip")

        with pytest.raises(KeyError):
            fn()
        from sentinel_tpu_torch.local.chain import cluster_node_map

        node = cluster_node_map()["deco_ig"]
        assert node.exception_qps(manual_clock.now_ms()) == 0

    def test_default_resource_name(self, manual_clock):
        @sentinel_resource()
        def some_fn():
            return 1

        some_fn()
        from sentinel_tpu_torch.local.chain import cluster_node_map

        assert any("some_fn" in name for name in cluster_node_map())

    def test_async_function(self, manual_clock):
        @sentinel_resource("deco_async", block_handler=lambda ex: "blocked")
        async def fn():
            return "ok"

        FlowRuleManager.load_rules([FlowRule(resource="deco_async", count=1)])
        assert asyncio.run(fn()) == "ok"
        assert asyncio.run(fn()) == "blocked"

    def test_async_handlers_are_awaited(self, manual_clock):
        async def on_block(ex):
            return "async-blocked"

        @sentinel_resource("deco_async_bh", block_handler=on_block)
        async def fn():
            return "ok"

        FlowRuleManager.load_rules([FlowRule(resource="deco_async_bh", count=1)])
        assert asyncio.run(fn()) == "ok"
        assert asyncio.run(fn()) == "async-blocked"  # result, not a coroutine

    def test_args_as_params_feed_hot_param_rules(self, manual_clock):
        from sentinel_tpu_torch.local import ParamFlowRule, ParamFlowRuleManager

        @sentinel_resource("deco_param", args_as_params=True,
                           block_handler=lambda uid, ex: "limited")
        def fn(uid):
            return "ok"

        ParamFlowRuleManager.load_rules(
            [ParamFlowRule(resource="deco_param", param_idx=0, count=1)]
        )
        assert fn("alice") == "ok"
        assert fn("alice") == "limited"  # per-value limit hit
        assert fn("bob") == "ok"  # other value unaffected


def _wsgi_app(environ, start_response):
    start_response("200 OK", [("Content-Type", "text/plain")])
    return [b"hello"]


def _call_wsgi(app, path="/", method="GET", remote="1.2.3.4"):
    status_headers = {}

    def start_response(status, headers):
        status_headers["status"] = status
        status_headers["headers"] = headers

    environ = {"REQUEST_METHOD": method, "PATH_INFO": path, "REMOTE_ADDR": remote}
    body = b"".join(app(environ, start_response))
    return status_headers["status"], body


class TestWsgi:
    def test_pass_and_block(self, manual_clock):
        app = SentinelWsgiMiddleware(_wsgi_app)
        FlowRuleManager.load_rules([FlowRule(resource="GET:/api", count=2)])
        for _ in range(2):
            status, body = _call_wsgi(app, "/api")
            assert status.startswith("200") and body == b"hello"
        status, body = _call_wsgi(app, "/api")
        assert status.startswith("429") and b"Sentinel" in body
        # other path unaffected
        status, _ = _call_wsgi(app, "/other")
        assert status.startswith("200")

    def test_custom_block_handler(self, manual_clock):
        def on_block(environ, start_response, e):
            start_response("503 Service Unavailable", [])
            return [b"custom"]

        app = SentinelWsgiMiddleware(_wsgi_app, block_handler=on_block)
        FlowRuleManager.load_rules([FlowRule(resource="GET:/x", count=0)])
        status, body = _call_wsgi(app, "/x")
        assert status.startswith("503") and body == b"custom"

    def test_skip_unnamed_resources(self, manual_clock):
        app = SentinelWsgiMiddleware(
            _wsgi_app, resource_extractor=lambda env: ""
        )
        FlowRuleManager.load_rules([FlowRule(resource="GET:/", count=0)])
        status, _ = _call_wsgi(app, "/")
        assert status.startswith("200")  # unguarded

    def test_total_entry(self, manual_clock):
        from sentinel_tpu_torch.adapters.wsgi import TOTAL_RESOURCE

        app = SentinelWsgiMiddleware(_wsgi_app, with_total=True)
        FlowRuleManager.load_rules([FlowRule(resource=TOTAL_RESOURCE, count=1)])
        assert _call_wsgi(app, "/a")[0].startswith("200")
        assert _call_wsgi(app, "/b")[0].startswith("429")  # umbrella cap

    def test_error_traced(self, manual_clock):
        def bad_app(environ, start_response):
            raise RuntimeError("boom")

        app = SentinelWsgiMiddleware(bad_app)
        with pytest.raises(RuntimeError):
            _call_wsgi(app, "/err")
        from sentinel_tpu_torch.local.chain import cluster_node_map

        node = cluster_node_map()["GET:/err"]
        assert node.exception_qps(manual_clock.now_ms()) > 0

    def test_streaming_body_holds_entry_open(self, manual_clock):
        """THREAD concurrency and RT must span body iteration, not just the
        app call (streaming responses)."""
        from sentinel_tpu_torch.local.chain import cluster_node_map

        observed = []

        def streaming_app(environ, start_response):
            start_response("200 OK", [])

            def gen():
                observed.append(cluster_node_map()["GET:/stream"].cur_thread_num)
                yield b"chunk"

            return gen()

        app = SentinelWsgiMiddleware(streaming_app)
        status_headers = {}
        body = app(
            {"REQUEST_METHOD": "GET", "PATH_INFO": "/stream", "REMOTE_ADDR": ""},
            lambda s, h: status_headers.update(status=s),
        )
        chunks = list(body)  # consume — entry held open during iteration
        assert chunks == [b"chunk"]
        assert observed == [1]  # concurrency visible mid-stream
        assert cluster_node_map()["GET:/stream"].cur_thread_num == 0  # released

    def test_streaming_iteration_error_traced(self, manual_clock):
        from sentinel_tpu_torch.local.chain import cluster_node_map

        def streaming_app(environ, start_response):
            start_response("200 OK", [])

            def gen():
                yield b"x"
                raise RuntimeError("mid-stream")

            return gen()

        app = SentinelWsgiMiddleware(streaming_app)
        body = app(
            {"REQUEST_METHOD": "GET", "PATH_INFO": "/stream2", "REMOTE_ADDR": ""},
            lambda s, h: None,
        )
        with pytest.raises(RuntimeError):
            list(body)
        node = cluster_node_map()["GET:/stream2"]
        assert node.exception_qps(manual_clock.now_ms()) > 0
        assert node.cur_thread_num == 0


async def _asgi_app(scope, receive, send):
    await send({"type": "http.response.start", "status": 200, "headers": []})
    await send({"type": "http.response.body", "body": b"hello"})


def _call_asgi(app, path="/", method="GET"):
    sent = []

    async def run():
        scope = {"type": "http", "method": method, "path": path,
                 "client": ("9.9.9.9", 1234)}

        async def receive():
            return {"type": "http.request"}

        async def send(msg):
            sent.append(msg)

        await app(scope, receive, send)

    asyncio.run(run())
    status = next(m["status"] for m in sent if m["type"] == "http.response.start")
    body = b"".join(m.get("body", b"") for m in sent if m["type"] == "http.response.body")
    return status, body


class TestAsgi:
    def test_pass_and_block(self, manual_clock):
        app = SentinelAsgiMiddleware(_asgi_app)
        FlowRuleManager.load_rules([FlowRule(resource="GET:/api", count=1)])
        assert _call_asgi(app, "/api") == (200, b"hello")
        status, body = _call_asgi(app, "/api")
        assert status == 429 and b"Sentinel" in body

    def test_non_http_passthrough(self, manual_clock):
        ran = []

        async def ws_app(scope, receive, send):
            ran.append(scope["type"])

        app = SentinelAsgiMiddleware(ws_app)

        async def run():
            await app({"type": "websocket"}, None, None)

        asyncio.run(run())
        assert ran == ["websocket"]

    def test_concurrent_tasks_have_isolated_contexts(self, manual_clock):
        """Two interleaving tasks must not corrupt each other's entry stack
        (the reference needs AsyncEntry for this; contextvars gives it)."""
        app = SentinelAsgiMiddleware(_asgi_app)
        order = []

        async def slow_app(scope, receive, send):
            order.append(f"in:{scope['path']}")
            await asyncio.sleep(0.01)
            order.append(f"out:{scope['path']}")
            await send({"type": "http.response.start", "status": 200, "headers": []})
            await send({"type": "http.response.body", "body": b"x"})

        app = SentinelAsgiMiddleware(slow_app)

        async def call(path):
            sent = []

            async def send(msg):
                sent.append(msg)

            await app({"type": "http", "method": "GET", "path": path,
                       "client": None}, None, send)
            return sent

        async def run():
            return await asyncio.gather(call("/a"), call("/b"))

        r = asyncio.run(run())
        assert all(any(m.get("status") == 200 for m in sent) for sent in r)
        assert order == ["in:/a", "in:/b", "out:/a", "out:/b"]  # interleaved


class TestGateway:
    def test_route_limit_per_client_ip(self, manual_clock):
        GatewayRuleManager.load_rules(
            [
                GatewayFlowRule(
                    resource="route_a", count=2,
                    param_item=GatewayParamFlowItem(ParseStrategy.CLIENT_IP),
                )
            ]
        )
        req1 = DictRequestAdapter(ip="10.0.0.1")
        req2 = DictRequestAdapter(ip="10.0.0.2")
        for _ in range(2):
            with GatewayRuleManager.entry("route_a", req1):
                pass
        with pytest.raises(BlockException):
            with GatewayRuleManager.entry("route_a", req1):
                pass
        # different IP gets its own bucket
        with GatewayRuleManager.entry("route_a", req2):
            pass

    def test_rule_without_param_item_acts_as_plain_limit(self, manual_clock):
        GatewayRuleManager.load_rules(
            [GatewayFlowRule(resource="route_b", count=1)]
        )
        with GatewayRuleManager.entry("route_b", DictRequestAdapter()):
            pass
        with pytest.raises(BlockException):
            with GatewayRuleManager.entry("route_b", DictRequestAdapter()):
                pass

    def test_header_with_pattern_matching(self, manual_clock):
        GatewayRuleManager.load_rules(
            [
                GatewayFlowRule(
                    resource="route_c", count=1,
                    param_item=GatewayParamFlowItem(
                        ParseStrategy.HEADER, field_name="X-Tier",
                        pattern="gold", match_strategy=MatchStrategy.EXACT,
                    ),
                )
            ]
        )
        gold = DictRequestAdapter(headers={"X-Tier": "gold"})
        bronze = DictRequestAdapter(headers={"X-Tier": "bronze"})
        args = GatewayRuleManager.parse("route_c", gold)
        assert args == ("gold",)
        assert GatewayRuleManager.parse("route_c", bronze) == (NOT_MATCH,)
        assert GatewayRuleManager.parse(
            "route_c", DictRequestAdapter()
        ) == (ABSENT,)

    def test_multiple_rules_align_param_indexes(self, manual_clock):
        GatewayRuleManager.load_rules(
            [
                GatewayFlowRule(
                    resource="route_d", count=10,
                    param_item=GatewayParamFlowItem(ParseStrategy.CLIENT_IP),
                ),
                GatewayFlowRule(
                    resource="route_d", count=5,
                    param_item=GatewayParamFlowItem(
                        ParseStrategy.URL_PARAM, field_name="user"
                    ),
                ),
            ]
        )
        req = DictRequestAdapter(ip="1.1.1.1", params={"user": "u7"})
        assert GatewayRuleManager.parse("route_d", req) == ("1.1.1.1", "u7")

    def test_removed_gateway_rules_are_unloaded(self, manual_clock):
        from sentinel_tpu_torch.local import ParamFlowRuleManager

        GatewayRuleManager.load_rules(
            [GatewayFlowRule(resource="route_gone", count=1)]
        )
        assert "route_gone" in ParamFlowRuleManager.all_rules()
        GatewayRuleManager.load_rules([])
        assert "route_gone" not in ParamFlowRuleManager.all_rules()

    def test_gateway_load_preserves_foreign_param_rules(self, manual_clock):
        from sentinel_tpu_torch.local import ParamFlowRule, ParamFlowRuleManager

        ParamFlowRuleManager.load_rules(
            [ParamFlowRule(resource="user_res", param_idx=0, count=3)]
        )
        GatewayRuleManager.load_rules(
            [GatewayFlowRule(resource="route_e", count=1)]
        )
        assert "user_res" in ParamFlowRuleManager.all_rules()
        assert "route_e" in ParamFlowRuleManager.all_rules()


class TestGrpc:
    def test_server_interceptor_blocks(self, manual_clock):
        grpc = pytest.importorskip("grpc")
        from concurrent import futures

        from sentinel_tpu_torch.adapters.grpc_interceptor import (
            SentinelServerInterceptor,
        )

        method = "/test.Svc/Do"

        class Handler(grpc.GenericRpcHandler):
            def service(self, details):
                if details.method == method:
                    return grpc.unary_unary_rpc_method_handler(
                        lambda req, ctx: req + b"!"
                    )
                return None

        server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=2),
            interceptors=[SentinelServerInterceptor()],
        )
        server.add_generic_rpc_handlers([Handler()])
        port = server.add_insecure_port("127.0.0.1:0")
        server.start()
        try:
            FlowRuleManager.load_rules([FlowRule(resource=method, count=1)])
            channel = grpc.insecure_channel(f"127.0.0.1:{port}")
            stub = channel.unary_unary(method)
            assert stub(b"hi", timeout=5) == b"hi!"
            with pytest.raises(grpc.RpcError) as exc_info:
                stub(b"hi", timeout=5)
            assert exc_info.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
            channel.close()
        finally:
            server.stop(0)


class TestHttpClient:
    def test_httpx_transport_guard(self, manual_clock):
        httpx = pytest.importorskip("httpx")
        from sentinel_tpu_torch.adapters.http_client import SentinelHttpxTransport

        calls = []

        def app(request):
            calls.append(str(request.url))
            return httpx.Response(200, text="ok")

        transport = SentinelHttpxTransport(inner=httpx.MockTransport(app))
        client = httpx.Client(transport=transport)
        FlowRuleManager.load_rules(
            [FlowRule(resource="GET:http://svc/api", count=1)]
        )
        assert client.get("http://svc/api").status_code == 200
        with pytest.raises(BlockException):
            client.get("http://svc/api")
        assert len(calls) == 1  # second call never reached the network

    def test_requests_session_guard(self, manual_clock):
        pytest.importorskip("requests")
        from sentinel_tpu_torch.adapters.http_client import guarded_requests_session

        session = guarded_requests_session()
        FlowRuleManager.load_rules(
            [FlowRule(resource="GET:http://127.0.0.1:1/x", count=0)]
        )
        with pytest.raises(BlockException):
            session.request("GET", "http://127.0.0.1:1/x")


class TestOriginPropagation:
    """Cross-service origin convention (adapters/origin.py): the outbound
    wrappers attach ``X-Sentinel-Origin: <app name>`` and the inbound
    adapters parse it into the context origin, so authority rules gate
    callers by *application* across an HTTP hop — the dubbo
    consumer→provider attachment idiom (``SentinelDubboProviderFilter``)."""

    @pytest.fixture()
    def app_name(self):
        from sentinel_tpu_torch.core.config import SentinelConfig

        SentinelConfig.set("csp.sentinel.app.name", "svc-a")
        yield "svc-a"
        SentinelConfig.reset_for_tests()

    def test_authority_rule_across_http_hop(self, manual_clock, app_name):
        # real wire hop: requests session → wsgiref server → wsgi middleware
        pytest.importorskip("requests")
        import threading
        from wsgiref.simple_server import WSGIServer, make_server

        import requests

        from sentinel_tpu_torch.adapters.http_client import guarded_requests_session
        from sentinel_tpu_torch.local.authority import (
            AuthorityRule,
            AuthorityRuleManager,
        )

        AuthorityRuleManager.load_rules(
            [AuthorityRule(resource="GET:/api", limit_app="svc-a")]
        )
        app = SentinelWsgiMiddleware(_wsgi_app)
        httpd = make_server("127.0.0.1", 0, app, server_class=WSGIServer)
        port = httpd.server_address[1]
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        try:
            session = guarded_requests_session()
            ok = session.request("GET", f"http://127.0.0.1:{port}/api")
            assert ok.status_code == 200  # origin svc-a is whitelisted
            bare = requests.get(f"http://127.0.0.1:{port}/api")
            assert bare.status_code == 429  # peer-IP origin is not
        finally:
            httpd.shutdown()
            httpd.server_close()
            t.join(timeout=5)

    def test_httpx_transport_attaches_origin(self, manual_clock, app_name):
        httpx = pytest.importorskip("httpx")
        from sentinel_tpu_torch.adapters.http_client import SentinelHttpxTransport

        seen = {}

        def app(request):
            seen.update(request.headers)
            return httpx.Response(200, text="ok")

        client = httpx.Client(
            transport=SentinelHttpxTransport(inner=httpx.MockTransport(app))
        )
        assert client.get("http://svc/api").status_code == 200
        assert seen.get("x-sentinel-origin") == "svc-a"

    def test_asgi_scope_prefers_origin_header(self):
        from sentinel_tpu_torch.adapters.asgi import default_origin

        scope = {
            "client": ("10.1.2.3", 1234),
            "headers": [
                (b"host", b"svc"),
                (b"x-sentinel-origin", b"svc-a"),
                (b"s-user", b"alice"),
            ],
        }
        assert default_origin(scope) == "svc-a"
        scope["headers"] = [(b"s-user", b"alice")]
        assert default_origin(scope) == "alice"
        scope["headers"] = []
        assert default_origin(scope) == "10.1.2.3"


class TestGatewayApiDefinitions:
    """ApiDefinition / matcher semantics (ApiDefinition.java,
    ApiPathPredicateItem.java, GatewayApiMatcherManager.java)."""

    @pytest.fixture(autouse=True)
    def clean_api(self):
        from sentinel_tpu_torch.adapters.gateway_api import (
            GatewayApiDefinitionManager, GatewayApiMatcherManager,
        )

        GatewayApiDefinitionManager.reset_for_tests()
        GatewayApiMatcherManager.reset_for_tests()
        yield
        GatewayApiMatcherManager.reset_for_tests()
        GatewayApiDefinitionManager.reset_for_tests()

    def _defs(self):
        from sentinel_tpu_torch.adapters.gateway_api import (
            ApiDefinition, ApiPathPredicateItem, ApiPredicateGroupItem,
            UrlMatchStrategy,
        )

        return [
            ApiDefinition("orders_api", (
                ApiPathPredicateItem("/orders", UrlMatchStrategy.EXACT),
                ApiPathPredicateItem("/orders/", UrlMatchStrategy.PREFIX),
            )),
            ApiDefinition("catalog_api", (
                ApiPredicateGroupItem((
                    ApiPathPredicateItem(r"^/catalog/\d+$",
                                         UrlMatchStrategy.REGEX),
                    ApiPathPredicateItem("/sku", UrlMatchStrategy.EXACT),
                )),
            )),
        ]

    def test_match_strategies(self):
        from sentinel_tpu_torch.adapters.gateway_api import (
            GatewayApiDefinitionManager, GatewayApiMatcherManager,
        )

        GatewayApiDefinitionManager.load_api_definitions(self._defs())
        pick = GatewayApiMatcherManager.pick_matching_api_names
        assert pick("/orders") == ["orders_api"]
        assert pick("/orders/42/items") == ["orders_api"]
        assert pick("/catalog/17") == ["catalog_api"]
        assert pick("/sku") == ["catalog_api"]
        assert pick("/other") == []

    def test_invalid_definitions_rejected(self):
        from sentinel_tpu_torch.adapters.gateway_api import (
            ApiDefinition, GatewayApiDefinitionManager,
        )

        GatewayApiDefinitionManager.load_api_definitions(
            [ApiDefinition("", ()), ApiDefinition("empty", ())]
        )
        assert GatewayApiDefinitionManager.get_api_definitions() == []

    def test_json_roundtrip(self):
        from sentinel_tpu_torch.adapters.gateway_api import (
            GatewayApiDefinitionManager, api_definition_to_dict,
            parse_api_definition,
        )

        for d in self._defs():
            assert parse_api_definition(api_definition_to_dict(d)) == d

    def test_property_driven_updates(self):
        from sentinel_tpu_torch.adapters.gateway_api import (
            GatewayApiDefinitionManager, GatewayApiMatcherManager,
        )
        from sentinel_tpu_torch.core.property import DynamicProperty

        prop = DynamicProperty()
        GatewayApiDefinitionManager.register_property(prop)
        prop.update_value(
            [{"apiName": "v_api",
              "predicateItems": [{"pattern": "/v/", "matchStrategy": 1}]}]
        )
        assert GatewayApiMatcherManager.pick_matching_api_names(
            "/v/x") == ["v_api"]
        prop.update_value([])
        assert GatewayApiMatcherManager.pick_matching_api_names("/v/x") == []

    def test_guard_enters_route_and_matching_apis(self, manual_clock):
        from sentinel_tpu_torch.adapters.gateway import GatewayGuard
        from sentinel_tpu_torch.adapters.gateway_api import (
            GatewayApiDefinitionManager,
        )

        GatewayApiDefinitionManager.load_api_definitions(self._defs())
        # rule on the CUSTOM API, not the route: only reachable through the
        # API-matching layer
        GatewayRuleManager.load_rules(
            [GatewayFlowRule(resource="orders_api", count=1,
                             resource_mode=ResourceMode.CUSTOM_API_NAME)]
        )
        req = DictRequestAdapter(ip="9.9.9.9")
        with GatewayGuard("route_orders", req, path="/orders/1"):
            pass
        with pytest.raises(BlockException):
            with GatewayGuard("route_orders", req, path="/orders/2"):
                pass
        # a path outside the API is not limited
        with GatewayGuard("route_orders", req, path="/other"):
            pass

    def test_gateway_wsgi_middleware_maps_path_to_api(self, manual_clock):
        from sentinel_tpu_torch.adapters.gateway import SentinelGatewayWsgiMiddleware
        from sentinel_tpu_torch.adapters.gateway_api import (
            GatewayApiDefinitionManager,
        )

        GatewayApiDefinitionManager.load_api_definitions(self._defs())
        GatewayRuleManager.load_rules(
            [GatewayFlowRule(resource="catalog_api", count=1,
                             resource_mode=ResourceMode.CUSTOM_API_NAME)]
        )

        def app(environ, start_response):
            start_response("200 OK", [("Content-Type", "text/plain")])
            return [b"ok"]

        mw = SentinelGatewayWsgiMiddleware(app)
        statuses = []

        def capture(status, headers):
            statuses.append(status)

        env = {"PATH_INFO": "/catalog/5", "REMOTE_ADDR": "1.2.3.4",
               "QUERY_STRING": ""}
        assert list(mw(dict(env), capture)) == [b"ok"]
        body = list(mw(dict(env), capture))
        assert statuses[-1].startswith("429")
        assert b"Blocked" in body[0]
        # non-matching path sails through
        env2 = {"PATH_INFO": "/healthz", "REMOTE_ADDR": "1.2.3.4",
                "QUERY_STRING": ""}
        assert list(mw(dict(env2), capture)) == [b"ok"]

    def test_regex_predicate_is_full_match(self):
        from sentinel_tpu_torch.adapters.gateway_api import (
            ApiDefinition, ApiPathPredicateItem, GatewayApiDefinitionManager,
            GatewayApiMatcherManager, UrlMatchStrategy,
        )

        GatewayApiDefinitionManager.load_api_definitions(
            [ApiDefinition("v1_api", (
                ApiPathPredicateItem(r"/v1/(orders|users)",
                                     UrlMatchStrategy.REGEX),
            ))]
        )
        pick = GatewayApiMatcherManager.pick_matching_api_names
        assert pick("/v1/orders") == ["v1_api"]
        # unanchored fragment must NOT over-match containing paths
        assert pick("/internal/v1/orders-export") == []
        assert pick("/v1/orders/extra") == []

    def test_header_rule_matches_canonical_case_behind_adapter(self, manual_clock):
        from sentinel_tpu_torch.adapters.gateway import _wsgi_request_adapter

        GatewayRuleManager.load_rules(
            [
                GatewayFlowRule(
                    resource="r_hdr", count=5,
                    param_item=GatewayParamFlowItem(
                        ParseStrategy.HEADER, field_name="X-Api-Key",
                    ),
                )
            ]
        )
        env = {"PATH_INFO": "/x", "HTTP_X_API_KEY": "k123"}
        req = _wsgi_request_adapter(env)
        # adapter lowercases; canonical-cased rule must still see the value
        assert GatewayRuleManager.parse("r_hdr", req) == ("k123",)

    def test_gateway_wsgi_streaming_holds_entries_open(self, manual_clock):
        from sentinel_tpu_torch.adapters.gateway import SentinelGatewayWsgiMiddleware
        from sentinel_tpu_torch.local.flow import FlowGrade

        GatewayRuleManager.load_rules(
            [GatewayFlowRule(resource="/stream", count=1,
                             grade=FlowGrade.THREAD)]
        )

        def app(environ, start_response):
            start_response("200 OK", [("Content-Type", "text/plain")])
            return iter([b"a", b"b"])

        mw = SentinelGatewayWsgiMiddleware(app)
        statuses = []

        def capture(status, headers):
            statuses.append(status)

        env = {"PATH_INFO": "/stream", "REMOTE_ADDR": "1.1.1.1",
               "QUERY_STRING": ""}
        body1 = mw(dict(env), capture)
        assert statuses[-1].startswith("200")
        # first body still streaming → concurrency slot held → second blocks
        body2 = mw(dict(env), capture)
        assert statuses[-1].startswith("429")
        body1.close()  # releases the entries
        body3 = mw(dict(env), capture)
        assert statuses[-1].startswith("200")
        list(body3)  # consume to completion also releases
        body4 = mw(dict(env), capture)
        assert statuses[-1].startswith("200")


class TestClassInterceptor:
    """sentinel_intercept — the CDI interceptor-binding analog
    (SentinelResourceInterceptor.java:35-70)."""

    def test_public_methods_guarded_with_formatted_names(self, manual_clock):
        from sentinel_tpu_torch.adapters import sentinel_intercept

        @sentinel_intercept()
        class Svc:
            def checkout(self, x):
                return x * 2

            def _internal(self, x):  # private: untouched
                return x

        FlowRuleManager.load_rules(
            [FlowRule(resource="Svc.checkout", count=1)]
        )
        s = Svc()
        assert s.checkout(3) == 6
        with pytest.raises(BlockException):
            s.checkout(4)
        assert s._internal(5) == 5  # never enters the slot chain
        assert not hasattr(Svc._internal, "__sentinel_resource__")

    def test_method_level_binding_wins(self, manual_clock):
        from sentinel_tpu_torch.adapters import sentinel_intercept

        @sentinel_intercept()
        class Svc:
            @sentinel_resource("custom_name")
            def pay(self, x):
                return x

        assert Svc.pay.__sentinel_resource__ == "custom_name"
        FlowRuleManager.load_rules(
            [FlowRule(resource="custom_name", count=1)]
        )
        s = Svc()
        assert s.pay(1) == 1
        with pytest.raises(BlockException):
            s.pay(2)

    def test_binding_level_fallback_and_static_methods(self, manual_clock):
        from sentinel_tpu_torch.adapters import sentinel_intercept

        def fb(*args, ex=None, **kwargs):
            return "fallback"

        @sentinel_intercept(fallback=fb)
        class Svc:
            def boom(self):
                raise ValueError("business error")

            @staticmethod
            def tally(x):
                return x + 1

        s = Svc()
        assert s.boom() == "fallback"  # traced, then binding fallback
        assert Svc.tally(1) == 2  # staticmethod rebound and callable
        assert Svc.__dict__["tally"].__func__.__sentinel_resource__ == (
            "Svc.tally"
        )

    def test_include_exclude_narrow_the_binding(self, manual_clock):
        from sentinel_tpu_torch.adapters import sentinel_intercept

        @sentinel_intercept(exclude=("skip_me",))
        class Svc:
            def a(self):
                return 1

            def skip_me(self):
                return 2

        assert hasattr(Svc.a, "__sentinel_resource__")
        assert not hasattr(Svc.skip_me, "__sentinel_resource__")

    def test_nested_classes_and_callable_instances_untouched(
        self, manual_clock
    ):
        import functools

        from sentinel_tpu_torch.adapters import sentinel_intercept

        @sentinel_intercept()
        class Svc:
            class Config:  # nested class: callable, must not be wrapped
                pass

            handler = functools.partial(int, "7")  # callable instance

            def work(self):
                return 1

        assert isinstance(Svc.Config, type)
        assert isinstance(Svc().Config(), Svc.Config)
        assert Svc().handler() == 7  # no self injected
        assert hasattr(Svc.work, "__sentinel_resource__")


# -- the reference's test_adapters_async_web.py --------------------------
class TestAiohttp:
    def _app(self):
        from aiohttp import web

        from sentinel_tpu_torch.adapters.aiohttp_middleware import sentinel_middleware

        async def hello(request):
            return web.json_response({"ok": True})

        async def boom(request):
            raise RuntimeError("kaput")

        app = web.Application(middlewares=[sentinel_middleware()])
        app.router.add_get("/hello", hello)
        app.router.add_get("/boom", boom)
        return app

    def _drive(self, paths):
        from aiohttp.test_utils import TestClient, TestServer

        async def run():
            client = TestClient(TestServer(self._app()))
            await client.start_server()
            try:
                out = []
                for p in paths:
                    resp = await client.get(p)
                    out.append((resp.status, await resp.text()))
                return out
            finally:
                await client.close()

        return asyncio.new_event_loop().run_until_complete(run())

    def test_pass_block_and_trace(self):
        FlowRuleManager.load_rules([FlowRule(resource="GET:/hello", count=2.0)])
        results = self._drive(["/hello"] * 4 + ["/boom"])
        statuses = [s for s, _ in results[:4]]
        assert statuses == [200, 200, 429, 429]
        assert json.loads(results[2][1])["error"].startswith("Blocked")
        assert results[4][0] == 500  # handler error propagates
        node = cluster_node_map()["GET:/hello"]
        assert node.pass_qps() == 2
        assert node.block_qps() == 2
        boom = cluster_node_map()["GET:/boom"]
        assert boom.exception_qps() == 1


class TestTornado:
    def _fetch(self, app, paths):
        from tornado.httpserver import HTTPServer
        from tornado.httpclient import AsyncHTTPClient
        from tornado.testing import bind_unused_port

        async def run():
            sock, port = bind_unused_port()
            server = HTTPServer(app)
            server.add_sockets([sock])
            client = AsyncHTTPClient()
            out = []
            try:
                for p in paths:
                    resp = await client.fetch(
                        f"http://127.0.0.1:{port}{p}", raise_error=False
                    )
                    out.append((resp.code, resp.body.decode()))
            finally:
                server.stop()
            return out

        return asyncio.new_event_loop().run_until_complete(run())

    def _app(self):
        from tornado import web

        from sentinel_tpu_torch.adapters.tornado_handler import (
            SentinelRequestHandlerMixin,
        )

        class Hello(SentinelRequestHandlerMixin, web.RequestHandler):
            def get(self):
                self.write("hi")

        class Boom(SentinelRequestHandlerMixin, web.RequestHandler):
            def get(self):
                raise RuntimeError("kaput")

        return web.Application([("/hello", Hello), ("/boom", Boom)])

    def test_pass_block_and_trace(self):
        FlowRuleManager.load_rules([FlowRule(resource="GET:/hello", count=2.0)])
        results = self._fetch(self._app(), ["/hello"] * 4 + ["/boom"])
        assert [s for s, _ in results[:4]] == [200, 200, 429, 429]
        assert "Blocked" in results[2][1]
        assert results[4][0] == 500
        node = cluster_node_map()["GET:/hello"]
        assert node.pass_qps() == 2
        assert node.block_qps() == 2
        assert cluster_node_map()["GET:/boom"].exception_qps() == 1
