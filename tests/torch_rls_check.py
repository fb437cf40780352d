"""The seeded Envoy RLS workload shared by ``tests/test_torch_envoy_rls.py``
and ``chip_smoke.py``'s phase 14a. No JAX here: either package's
``cluster.envoy_rls`` module is passed in.

Rules have the reference's ``EnvoyRlsRule`` shape (a domain, descriptors of
key/value entries and a count; ``sentinel-cluster-server-envoy-rls``):
descriptor ``i`` of ``n`` lives in domain ``i % domains``, carries the first
``1 + i % 3`` of ``KEYS`` and counts ``100 + i % 100`` a second (the
base is a parameter, for small streams). A request
names one domain and 1-4 of its descriptors, bounded-Zipf over them; a
share of the descriptors names no rule, and ``hits_addend`` is 0, 1 or 3.
"""

from __future__ import annotations

import numpy as np

KEYS = ("destination_cluster", "generic_key", "remote_address")
HITS = (0, 1, 3)


def _entries(i: int):
    # the first entry is unique to the descriptor, so no two share a key
    vals = (f"cluster-{i}", f"key-{i % 977}", f"10.{i // 65536 % 256}."
            f"{i // 256 % 256}.{i % 256}")
    return tuple((KEYS[k], vals[k]) for k in range(1 + i % 3))


def rule_spec(n: int, domains: int = 16, base: int = 100):
    """``[(domain, [(entries, count), ...]), ...]``: ``n`` descriptors,
    descriptor ``i`` counting ``base + i % 100`` a second."""
    out = []
    for d in range(domains):
        descs = [(_entries(i), float(base + i % 100))
                 for i in range(d, n, domains)]
        out.append((f"domain-{d}", descs))
    return out


def build_rules(R, spec):
    """``spec`` as ``EnvoyRlsRule`` objects of the module ``R``."""
    return [R.EnvoyRlsRule(domain, tuple(R.RlsDescriptor(e, c)
                                         for e, c in descs))
            for domain, descs in spec]


def stream(spec, n_requests: int, rng, alpha: float = 1.1,
           miss: float = 0.02, max_desc: int = 4):
    """``[(domain, descriptors, hits_addend)]``: each request's domain is
    drawn by its descriptors' share, its descriptors bounded-Zipf within
    the domain (rank = the descriptor's place in the domain), a ``miss``
    share of them replaced by entries no rule names."""
    sizes = np.array([len(descs) for _d, descs in spec], np.float64)
    out = []
    cdfs = {}
    for r in range(n_requests):
        d = int(rng.choice(len(spec), p=sizes / sizes.sum()))
        domain, descs = spec[d]
        cdf = cdfs.get(d)
        if cdf is None:
            w = np.arange(1, len(descs) + 1, dtype=np.float64) ** -alpha
            cdf = cdfs[d] = np.cumsum(w / w.sum())
        k = int(rng.integers(1, max_desc + 1))
        ranks = np.minimum(np.searchsorted(cdf, rng.random(k)),
                           len(descs) - 1)
        picked = []
        for j, rank in enumerate(ranks):
            if rng.random() < miss:
                picked.append([("generic_key", f"no-rule-{r}-{j}")])
            else:
                picked.append([tuple(e) for e in descs[int(rank)][0]])
        out.append((domain, picked, int(HITS[int(rng.integers(3))])))
    return out


def answer(R, rls, domain, descriptors, hits) -> bytes:
    """One request through the wire codec: encode, decode, answer, encode
    the response."""
    req = R.encode_rate_limit_request(domain, descriptors, hits)
    d, descs, h = R.decode_rate_limit_request(req)
    return R.encode_rate_limit_response(rls.should_rate_limit(d, descs, h))


def drive(R, rls, requests, advance, steps_ms=(0, 1, 2, 1)):
    """Every request answered in order, the clock advanced between them by
    ``steps_ms`` in turn; returns the response bytes."""
    out = []
    for i, (domain, descs, hits) in enumerate(requests):
        out.append(answer(R, rls, domain, descs, hits))
        advance(steps_ms[i % len(steps_ms)])
    return out


def summary(R, responses) -> dict:
    """Overall and per-descriptor code counts of encoded responses."""
    overall = {}
    statuses = {}
    limited = 0
    for raw in responses:
        v = R.decode_rate_limit_response(raw)
        overall[v.overall_code] = overall.get(v.overall_code, 0) + 1
        for st in v.statuses:
            statuses[st.code] = statuses.get(st.code, 0) + 1
            limited += st.limit_per_unit is not None
    return {"overall": overall, "descriptors": statuses,
            "with_limit": limited}
