"""Scene-pipelined evaluation: network calls batched across scenes.

Port of `suo_slam_tpu/eval/pipeline.py`. `evaluate.py --nviews -1` runs its
scenes one after another, and each frame's network call carries only that
frame's object bucket (~8 crops), bound by the host's dispatch. Scenes are
independent SLAM problems, so they pipeline: K scenes (or, for SfM, K
keyframe re-solves) run on K worker threads, each with its own engine
(state, priors, BA graph), and a `BatchingInferServer` collects one pending
network request per live engine and serves them all in one multi-frame call
(`slam.kernels.make_multi_frame_inference`). The prior feedback keeps each
scene sequential; throughput comes from batching across scenes.

The engines are untouched: the server hands each one a callable with the
`make_frame_inference` signature through its `infer_fn` injection point.
With a persisted int8 scales sidecar the batched outputs equal the
per-frame program's bit for bit, so the results equal the sequential
sweep's; scoring runs on the main thread in scene order either way. Every
network call runs under the server's lock, on one thread at a time.
"""

from __future__ import annotations

import threading

import torch

from ..slam.engine import MIN_PAD_BOX


class BatchingInferServer:
    """Batches concurrent engines' network calls into one call.

    n_clients engines each own a client callable (`client(cid)`); a call
    blocks until every live client has a request pending, then the last to
    arrive assembles the [G = n_clients, O = the largest bucket] batch
    (finished clients' rows and padded slots invalid) and runs `multi_fn`
    once. A client that has finished its work calls `done(cid)`, which
    shrinks the barrier; `abort(exc)` wakes every waiter with the error. The
    batch is assembled on the device (`torch.stack` and padding of the
    engines' device tensors).
    """

    def __init__(self, multi_fn, n_clients: int):
        self._fn = multi_fn
        self._cv = threading.Condition()
        self._active = int(n_clients)
        self._n = int(n_clients)
        self._pending: dict[int, tuple] = {}
        self._results: dict[int, tuple] = {}
        self._error: BaseException | None = None

    # ------------------------------------------------------------- client --
    def client(self, cid: int):
        def infer(img, boxes, obj_valid, prior_uv, prior_valid, has_prior=True):
            with self._cv:
                self._pending[cid] = (img, boxes, obj_valid, prior_uv, prior_valid,
                                      bool(has_prior))
                while cid not in self._results:
                    if self._error is not None:
                        raise RuntimeError("pipelined inference aborted by a peer scene") \
                            from self._error
                    if self._pending and len(self._pending) >= self._active:
                        self._dispatch_locked()
                    else:
                        self._cv.wait(timeout=1.0)
                return self._results.pop(cid)

        # the engine probes this on the callable (see make_frame_inference)
        infer.supports_no_prior = True
        return infer

    def done(self, cid: int):
        """A client finished (or died): shrink the barrier, so that a full
        round of the remaining clients can be dispatched by whoever waits."""
        with self._cv:
            self._active -= 1
            self._cv.notify_all()

    def abort(self, exc: BaseException):
        """Wake every waiter with a worker's exception instead of hanging."""
        with self._cv:
            self._error = exc
            self._cv.notify_all()

    # ----------------------------------------------------------- dispatch --
    def _dispatch_locked(self):
        """Assemble and run the batch. On any failure, record the error so
        that the clients whose requests were consumed raise instead of
        waiting for ever; the dispatching client re-raises its own."""
        try:
            self._dispatch_inner()
        except BaseException as e:  # noqa: BLE001 — delivered to all waiters
            self._error = e
            self._cv.notify_all()
            raise

    def _dispatch_inner(self):
        reqs = self._pending
        self._pending = {}
        cids = sorted(reqs)
        img0, _, _, puv0, _, _ = reqs[cids[0]]
        dev = img0.device
        h, w = img0.shape[:2]
        nk = puv0.shape[-2]
        o = max(int(reqs[c][1].shape[0]) for c in cids)
        any_prior = any(reqs[c][5] for c in cids)
        f32 = torch.float32
        # masked-out slots still go through the ROI crop, so they get the
        # engine's harmless nonzero pad box
        pad_box = torch.tensor([0.0, 0.0, MIN_PAD_BOX, MIN_PAD_BOX], dtype=f32, device=dev)

        def pad_o(a, box=False):
            n = int(a.shape[0])
            if n == o:
                return a
            fill = (pad_box.expand(o - n, 4) if box
                    else a.new_zeros((o - n,) + tuple(a.shape[1:])))
            return torch.cat([a, fill])

        rows = {"img": [], "boxes": [], "valid": [], "puv": [], "pval": []}
        for c in cids:
            img, boxes, valid, puv, pval, _ = reqs[c]
            if tuple(img.shape[:2]) != (h, w):
                raise ValueError("pipelined scenes must share an image size; got "
                                 f"{tuple(img.shape[:2])} vs {(h, w)}")
            rows["img"].append(img.to(dev, f32))
            rows["boxes"].append(pad_o(boxes.to(dev, f32), box=True))
            rows["valid"].append(pad_o(valid.to(dev, torch.bool)))
            rows["puv"].append(pad_o(puv.to(dev, f32)))
            rows["pval"].append(pad_o(pval.to(dev, torch.bool)))
        # pad the scene axis to the construction-time client count, so that
        # the batch keeps one G as scenes finish
        for _ in range(self._n - len(cids)):
            rows["img"].append(torch.zeros((h, w, 3), dtype=f32, device=dev))
            rows["boxes"].append(pad_box.expand(o, 4))
            rows["valid"].append(torch.zeros((o,), dtype=torch.bool, device=dev))
            rows["puv"].append(torch.zeros((o, nk, 2), dtype=f32, device=dev))
            rows["pval"].append(torch.zeros((o, nk), dtype=torch.bool, device=dev))
        uv, cov, mask = self._fn(
            torch.stack(rows["img"]), torch.stack(rows["boxes"]), torch.stack(rows["valid"]),
            torch.stack(rows["puv"]), torch.stack(rows["pval"]), has_prior=any_prior)
        for i, c in enumerate(cids):
            oi = int(reqs[c][1].shape[0])
            self._results[c] = (uv[i, :oi], None if cov is None else cov[i, :oi], mask[i, :oi])
        self._cv.notify_all()


class ScenePool:
    """K worker threads draining a work queue in the declared order.

    `run_scene(cid, key)` is the caller's per-item closure (build an engine
    with `server.client(cid)` injected, drive its views, return what scoring
    needs). Results come back as {key: value}; the first worker exception
    aborts the server (so no peer hangs at the barrier) and is re-raised on
    the calling thread.
    """

    def __init__(self, server: BatchingInferServer | None, n_workers: int):
        self._server = server
        self._n = int(n_workers)

    def run(self, scene_ids, run_scene):
        work = list(scene_ids)
        lock = threading.Lock()
        results: dict = {}
        errors: list[BaseException] = []

        def worker(cid):
            try:
                while True:
                    with lock:
                        if errors or not work:
                            break
                        scene_id = work.pop(0)
                    results[scene_id] = run_scene(cid, scene_id)
            except BaseException as e:  # noqa: BLE001 — re-raised on the caller's thread
                with lock:
                    errors.append(e)
                if self._server is not None:
                    self._server.abort(e)
            finally:
                if self._server is not None:
                    self._server.done(cid)

        threads = [threading.Thread(target=worker, args=(cid,), daemon=True)
                   for cid in range(self._n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return results
