"""Online diversity serving end to end: a simulated recommendation stream
is ingested asynchronously (a background submit worker publishing epoch
snapshots of the resumable Alg.-2 scan), TWO tenants (different metrics,
one physical stream) answer bursts of heterogeneous queries from their
own cached coreset distance matrices, and the single-tenant
``DiversityService`` facade shows the same answers: the paper's
web-search/recommendation workload (section 1) with the coreset as the
only serving state.

At exit the run's observability artifacts are written to ``--out-dir``
(default: the system temp dir): a JSONL metrics snapshot (every serving
counter and histogram this run touched) and a Chrome ``trace_event`` file
(open it at chrome://tracing or https://ui.perfetto.dev to see the submit
-> ingest -> publish -> query -> solve span tree, one trace ID a request).

    PYTHONPATH=src python -m repro_torch.examples.diversity_service \\
        [--device cpu]

Reference: ``examples/diversity_service.py``.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from repro_torch import obs
from repro_torch.core import solve_dmmc
from repro_torch.core.matroid import MatroidSpec
from repro_torch.device import resolve_device
from repro_torch.serve.diversity import (
    DiversityQuery,
    DiversityService,
    QueryFrontend,
    StreamRuntime,
)


def make_catalog(rng, n, h):
    """A songs-like catalog: 16 genres, skewed sizes, genre caps."""
    genre = rng.choice(h, n, p=rng.dirichlet(np.ones(h)))
    basis = rng.normal(size=(5, 64))
    points = (rng.normal(size=(h, 5))[genre] * 2 @ basis
              + rng.normal(size=(n, 64))).astype(np.float32)
    caps = np.full(h, 2, np.int32)
    spec = MatroidSpec("partition", num_categories=h, gamma=1)
    return points, genre, caps, spec


def run(device: str = "cuda", n: int = 20000, batch: int = 1000,
        out_dir: str | None = None) -> dict:
    dev = resolve_device(device)
    rng = np.random.default_rng(7)
    h, k, tau = 16, 8, 32
    points, genre, caps, spec = make_catalog(rng, n, h)

    # ---- the layered runtime: one stream, async ingest, two tenants ----
    rt = StreamRuntime(spec, k, tau=tau, caps=caps, device=dev)
    fe = QueryFrontend(rt)
    # tenant 2: same stream, cosine geometry, its own cached matrix
    fe.register_tenant("cosine", metric="cosine")

    with rt:  # the catalog arrives in non-blocking batches
        for off in range(0, n, batch):
            rt.submit(points[off:off + batch], genre[off:off + batch, None])
        epoch = fe.flush()  # freshness barrier: everything submitted is in
        snap = rt.latest()
        print(f"ingested {snap.n_offered} items asynchronously; epoch "
              f"{epoch} serves a {snap.size}-point coreset "
              f"(+{tau + 1}-center scan state)")

        # a burst of user queries per tenant: result sizes, genre filters,
        # caps, answered on each tenant's own cached matrix
        burst = [
            DiversityQuery(k=8),                                   # homepage
            DiversityQuery(k=4, allowed_cats=frozenset(range(4))), # rock tab
            DiversityQuery(k=6, caps=(1,) * h),                    # 1/genre
            DiversityQuery(k=8, variant="tree"),                   # playlist
            DiversityQuery(k=8, variant="tree",                    # same, fast
                           engine_hint="jit_greedy"),              # greedy
        ]
        for tenant in ("default", "cosine"):
            results = fe.query_batch(burst, tenant=tenant,
                                     min_epoch=epoch)
            print(f"tenant {tenant!r} (metric="
                  f"{fe.tenants.get(tenant).metric}):")
            for q, r in zip(burst, results):
                print(f"  k={q.k} variant={q.variant:<4} "
                      f"engine={r.engine:<15} epoch={r.epoch} "
                      f"div={r.diversity:9.3f} "
                      f"items={sorted(r.indices.tolist())}")
        st = fe.stats()
        print(f"stats: {st['cache']['builds']} pdist build(s) for "
              f"{len(st['tenants'])} tenants over one stream, "
              f"{st['cache']['hits']} cache hits, "
              f"{st['epochs_published']} epoch(s) published, "
              f"{st['snapshot_materializations']} materialization(s)")

    # ---- the single-tenant facade: the historical API ----
    svc = DiversityService(spec, k, tau=tau, caps=caps, device=dev)
    for off in range(0, n, batch):
        svc.ingest(points[off:off + batch], genre[off:off + batch, None])
    res = svc.query_batch(burst)[0]

    # the cached answer matches the offline driver's answer (the fast
    # engines guarantee the same selection; the host engine also matches
    # the offline selection order bit for bit)
    sol = solve_dmmc(points, k, spec, cats=genre[:, None], caps=caps,
                     tau=tau, setting="streaming", device=dev)
    assert sorted(res.indices.tolist()) == sorted(sol.indices.tolist())
    assert res.diversity == sol.diversity
    # ... and the async runtime's default tenant answered the same
    # query identically: same stream content, same coreset
    first = fe.query(burst[0], tenant="default")
    assert sorted(first.indices.tolist()) == sorted(sol.indices.tolist())
    print(f"parity with offline solve_dmmc confirmed "
          f"(div={sol.diversity:.3f}) for the facade AND the async runtime")

    # ---- observability: everything above was measured as it ran ----
    q_lat = obs.histogram("serve.query.latency_s", tenant="default")
    i_lat = None
    for m in obs.default_registry().series():
        if m.name == "serve.ingest.latency_s":
            i_lat = m
    print(f"observability: {q_lat.count} default-tenant query batches "
          f"(p95 {q_lat.quantile(0.95) * 1e3:.1f} ms), "
          f"{i_lat.count} ingest batches "
          f"(p95 {i_lat.quantile(0.95) * 1e3:.1f} ms), "
          f"{obs.counter('serve.epoch.published').value} epochs published")
    out = out_dir or tempfile.gettempdir()
    os.makedirs(out, exist_ok=True)
    metrics_path = os.path.join(out, "diversity_service.metrics.jsonl")
    trace_path = os.path.join(out, "diversity_service.trace.json")
    obs.write_metrics_jsonl(metrics_path)
    obs.dump_trace(trace_path)
    print(f"metrics snapshot -> {metrics_path}")
    print(f"request trace    -> {trace_path}  (chrome://tracing)")
    fe.close()
    svc.close()
    return dict(sol=sol, facade=res, first=first, metrics=metrics_path,
                trace=trace_path)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args(argv)
    run(args.device, n=args.n, out_dir=args.out_dir)


if __name__ == "__main__":
    main()
