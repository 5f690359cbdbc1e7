"""Block-streamed reconciliation over unbounded symbol streams.

Arbitrarily long correlated (x, y) symbol streams are cut into code frames
with carry-over boundary handling: symbols that arrive mid-frame wait in a
carry buffer until their frame completes, and complete frames are decoded
in batches of a fixed size, so every decode sees exactly ``batch`` frames
(a partial tail is padded by repeating its last frame).

The Bob-side and Alice-side steps are split as the protocol splits them:
``bob_process`` consumes y and emits (hard words, syndromes, softening
metrics); ``alice_process`` consumes (softening metrics, Alice's x) with
Bob's syndromes and emits corrected hard words.  ``bob_step`` /
``alice_step`` keep Bob's outputs on the device between the two sides, and
``stream_fused`` runs both sides in one pass a batch, on one device or
frame-sharded over the ranks of a mesh (``mesh_axis``).

Host arrays are cast to the mapper's dtype on the host before they are
uploaded (a float64 sample rounds to bf16 through float32, as the JAX
package's host cast does).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .engine import mesh_of

__all__ = ["StreamReconciler", "StreamResult", "DeviceHandoff"]


@dataclass
class DeviceHandoff:
    """Device-resident Bob->Alice batch handoff (see
    :meth:`StreamReconciler.bob_step`).

    Holds one entry per dispatched batch: ``(words [B, N], synd [B, C],
    n_hat [B, N_symb], take)``, device tensors padded to the reconciler's
    fixed batch with ``take`` real frames.  They hold device memory until
    :meth:`StreamReconciler.alice_step` consumes them.  Where Bob and Alice
    run on different hosts the split ``bob_process``/``alice_process`` API
    is the faithful boundary; this handle is the co-located simulation's
    path, without the device->host->device round trip of Bob's outputs."""

    batches: list = field(default_factory=list)
    frames: int = 0


def _make_pack_bits(N: int):
    """[B, N] 0/1 int tensor -> [B, ceil(N/8)] uint8 packer, little bit
    order (``np.unpackbits(..., bitorder='little')`` reads it back): the
    packed-word download of the fused and handoff paths."""
    npad = (-N) % 8

    def pack_bits(bits_bn):
        if npad:
            bits_bn = torch.cat([bits_bn, bits_bn.new_zeros(
                (bits_bn.shape[0], npad))], dim=1)
        g = bits_bn.reshape(bits_bn.shape[0], -1, 8).to(torch.int32)
        w = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.int32,
                         device=bits_bn.device)
        return torch.sum(g * w, dim=-1).to(torch.uint8)

    return pack_bits


def _upload(a, dtype, device):
    """Host array ``a`` as a tensor of ``dtype`` on ``device``, cast on the
    host."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype, copy=True)
    return t.to(device)


def _host(t):
    """Device tensor -> numpy (bf16 as float32, which holds it exactly)."""
    t = t.cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class _Queue:
    """A host FIFO of rows of one shape that grows in place: rows are
    appended at the back and taken from the front.  Fed in small chunks it
    copies each row once on the way in, where concatenating the whole
    queue on every call copies it once per call."""

    def __init__(self, dtype, row=()):
        self.buf = np.empty((0, *row), dtype)
        self.lo = self.hi = 0

    def __len__(self):
        return self.hi - self.lo

    def append(self, rows):
        row = self.buf.shape[1:]
        rows = np.asarray(rows, self.buf.dtype).reshape(-1, *row)
        n, keep = rows.shape[0], len(self)
        if self.hi + n > self.buf.shape[0]:
            cap = max(self.buf.shape[0], 2 * (keep + n))
            if cap > self.buf.shape[0]:
                grown = np.empty((cap, *row), self.buf.dtype)
                grown[:keep] = self.buf[self.lo:self.hi]
                self.buf = grown
            else:
                self.buf[:keep] = self.buf[self.lo:self.hi]
            self.lo, self.hi = 0, keep
        self.buf[self.hi:self.hi + n] = rows
        self.hi += n

    def take(self, n):
        """The first ``n`` rows, removed from the queue (a view, valid
        until the next append)."""
        out = self.buf[self.lo:self.lo + n]
        self.lo += n
        return out


@dataclass
class StreamResult:
    """Aggregated streaming statistics + decoded payload."""

    frames: int = 0
    decoded_words: list = field(default_factory=list)   # [N]-bit arrays
    success: list = field(default_factory=list)          # per-frame bool
    iterations: list = field(default_factory=list)       # per-frame int
    bit_errors: int = 0                                  # vs Bob's words

    @property
    def fer(self) -> float:
        return (
            0.0 if not self.success
            else 1.0 - sum(self.success) / len(self.success)
        )


class StreamReconciler:
    """Frame-aligned block streaming over a (code, alphabet, noise) triple.

    Args:
      dec, mat, pa, nm: decoder (``Decoder`` or ``QCDecoder``, through its
        ``_build_decode()`` entry on ``[N, B]`` / ``[C, B]``), parity
        matrix, alphabet, noise mapper.  Samples go to the mapper's device
        (``cuda`` unless it was built with ``device="cpu"``).
      batch: frames processed per device round on both sides (a partial
        tail block is padded up to ``batch``, so every decode sees exactly
        ``batch`` frames).
      llr_mode: Alice's softening LLRs, ``NoiseMapper.demap_lappr_array``'s
        mode: "poly" (default), "table", "interp" or "search".
      defer: hold completed frames until a full batch accumulates instead
        of padding every partial block (the throughput mode for streams fed
        in chunks smaller than ``batch * N_symb`` symbols).  Outputs are
        delayed until batches fill, plus one batch: each side keeps its
        newest batch pending and harvests it on the next call.  Drain the
        tails with ``bob_flush()`` / ``alice_flush()``.  Default False
        (emit-immediately semantics).
      mesh_axis: optional ``(mesh, axis_name)``
        (``parallel.mesh.make_mesh``): ``stream_fused`` shards each batch's
        frames over the mesh's ranks, ``batch / world`` frames a rank
        (``batch`` must divide), and all-gathers the per-frame outputs in
        frame order, so every rank's ``StreamResult`` equals the
        single-device one.  The decoder and the mapper live on this rank's
        device.  The split and handoff drivers stay single-device.
    """

    def __init__(self, dec, mat, pa, nm, batch: int = 32,
                 llr_mode: str = "poly", defer: bool = False,
                 mesh_axis=None):
        if mat.vnum % pa.bit_per_symbol != 0:
            raise ValueError("code length not divisible by bits/symbol")
        self.mesh = mesh_of(mesh_axis)
        if self.mesh is not None and batch % self.mesh.world:
            raise ValueError(
                f"batch {batch} must divide over the {self.mesh} mesh")
        self.dec = dec
        self.mat = mat
        self.pa = pa
        self.nm = nm
        self.device = nm.device
        self.batch = int(batch)
        self.llr_mode = llr_mode
        self.N = mat.vnum
        self.N_symb = mat.vnum // pa.bit_per_symbol
        self._carry_y = np.empty(0, np.float64)
        self._carry_x = np.empty(0, np.int64)
        self.defer = bool(defer)
        # the frame queues: Bob's completed frames (defer mode and the
        # handoff) and Alice's aligned x / n_hat / synd / words rows
        self._bob_q = _Queue(np.float64, (self.N_symb,))
        self._aq_x = _Queue(np.int64, (self.N_symb,))
        self._aq_nhat = _Queue(np.float64, (self.N_symb,))
        self._aq_synd = _Queue(np.uint8, (mat.cnum,))
        self._aq_words = _Queue(np.uint8, (self.N,))
        # the bob_words accounting mode latches on the first deferred
        # enqueue: rows queued without words cannot be aligned to words
        # that arrive later
        self._aq_words_mode = None
        self.decode_dispatches = 0  # decode calls (waste accounting)
        # defer mode: the last batch of each call stays pending, (device
        # outputs, accounting), and the next call (or the flush) harvests
        # it, so outputs come out one batch later
        self._bob_pending = None
        self._alice_pending = None
        # symbol indices go up at the smallest sufficient width
        self._idx_dt = ((np.uint8, torch.uint8) if pa.order <= 256
                        else (np.int32, torch.int32))
        self._pack = _make_pack_bits(self.N)
        self._decode_fn = dec._build_decode()
        if llr_mode == "table":
            nm._ensure_llr_tab()
        elif llr_mode == "poly":
            nm._ensure_llr_poly()

    # ----------------------------------------------------- round bodies

    def _bob_round(self, y):
        """y [B, S] -> (words [B, N] uint8, synd [B, C] uint8, n_hat [B, S])."""
        x_hat = self.nm.hard_decide_index(y)
        n_hat = self.nm.map_noise(y, x_hat)
        words = self.pa.demap_symbols_to_bits(x_hat)
        synd = self.mat.eval_syndrome(words)
        return words, synd, n_hat

    def _alice_round(self, n_hat, x, synd, max_iter):
        """Alice's LLRs from (n_hat, x) [B, S], then the decode of the
        [N, B] LLRs against the [C, B] syndromes: (success, iters, total)."""
        lappr = self.nm.demap_lappr_array(n_hat, x, mode=self.llr_mode)
        return self._decode_fn(lappr.T, synd.T, max_iter)

    def _alice_handoff_round(self, n_hat, x, synd, words, max_iter):
        """:meth:`_alice_round` with the bit errors against Bob's words
        counted on the device and the decoded words packed."""
        success, iters, total = self._alice_round(n_hat, x, synd, max_iter)
        alice_bits = (total.T < 0).to(torch.int32)            # [B, N]
        errs = torch.sum(alice_bits ^ words.to(torch.int32), dim=1)
        return success, iters, errs, self._pack(alice_bits)

    def _fused_round(self, y, x, max_iter):
        """Bob's round feeding Alice's, in one pass on the device."""
        words, synd, n_hat = self._bob_round(y)
        return self._alice_handoff_round(n_hat, x, synd, words, max_iter)

    def _sharded_fused_round(self, yb, xb, max_iter):
        """:meth:`_fused_round` on this rank's ``batch / world`` frames of
        the host batch ``(yb, xb)``; the outputs all-gathered in frame
        order, the same on every rank."""
        mesh = self.mesh
        b = self.batch // mesh.world
        lo = mesh.rank * b
        out = self._fused_round(self._upload_y(yb[lo:lo + b]),
                                self._upload_x(xb[lo:lo + b]), max_iter)
        return tuple(mesh.all_gather(o).reshape(self.batch, *o.shape[1:])
                     for o in out)

    def _pad(self, blk):
        """A block of fewer than ``batch`` rows padded by its last row."""
        pad = self.batch - blk.shape[0]
        if pad:
            blk = np.concatenate([blk, np.repeat(blk[-1:], pad, 0)])
        return blk

    def _upload_y(self, blk):
        return _upload(blk, self.nm.dtype, self.device)

    def _upload_x(self, blk):
        host, dev = self._idx_dt
        return _upload(blk.astype(host), dev, self.device)

    def _empty_bob(self):
        return (np.empty((0, self.N), np.uint8),
                np.empty((0, self.mat.cnum), np.uint8),
                np.empty((0, self.N_symb)))

    # ---------------------------------------------------------------- Bob

    def bob_process(self, y_block):
        """Consume a block of Bob's samples; emit completed frames.

        Returns ``(words [F, N] uint8, synd [F, C] uint8, n_hat [F, N_symb])``
        for however many frames completed (F may be 0); incomplete-tail
        symbols are carried into the next call.  Frames are processed in
        ``batch``-sized blocks with tail padding.
        """
        if not self.defer and len(self._bob_q):
            # frames queued by bob_step would be skipped (and later
            # dispatched out of stream order) by the immediate path
            raise ValueError(
                "bob_process(defer=False) after bob_step left queued "
                "frames; drain them with bob_step_flush() first (or stay "
                "on one API per reconciler)"
            )
        y = np.concatenate([self._carry_y,
                            np.asarray(y_block, np.float64).ravel()])
        F = y.size // self.N_symb
        self._carry_y = y[F * self.N_symb:]
        yf = y[: F * self.N_symb].reshape(F, self.N_symb)
        if self.defer:
            self._bob_q.append(yf)
            yf = self._bob_q.take(len(self._bob_q) // self.batch * self.batch)
        if yf.shape[0] == 0 and self._bob_pending is None:
            return self._empty_bob()
        return self._bob_run(yf, leave_pending=self.defer)

    def bob_flush(self):
        """Drain Bob's deferred frame queue (padded tail batch, once) and
        any pending batch.  Returns the same triple as :meth:`bob_process`
        (empty arrays when nothing is queued or pending)."""
        yf = self._bob_q.take(len(self._bob_q))
        if yf.shape[0] == 0 and self._bob_pending is None:
            return self._empty_bob()
        return self._bob_run(yf, leave_pending=False)

    def _bob_run(self, yf, leave_pending=False):
        """Batch-blocked processing of complete frames [F, N_symb]."""
        F = yf.shape[0]
        words_l, synd_l, nhat_l = [], [], []

        def harvest(pend):
            (w, s, nh), take = pend
            words_l.append(_host(w[:take]))
            synd_l.append(_host(s[:take]))
            nhat_l.append(_host(nh[:take]))

        # block r+1 is issued before block r is read back; in defer mode
        # the pending slot persists across calls (see __init__)
        for lo in range(0, F, self.batch):
            hi = min(lo + self.batch, F)
            out = self._bob_round(self._upload_y(self._pad(yf[lo:hi])))
            if self._bob_pending is not None:
                harvest(self._bob_pending)
            self._bob_pending = (out, hi - lo)
        if not leave_pending and self._bob_pending is not None:
            harvest(self._bob_pending)
            self._bob_pending = None
        if not words_l:
            return self._empty_bob()
        return (np.concatenate(words_l, axis=0),
                np.concatenate(synd_l, axis=0),
                np.concatenate(nhat_l, axis=0))

    # -------------------------------------------------------------- Alice

    def alice_process(self, n_hat, x_block, synd, max_iterations: int = 50,
                      bob_words=None):
        """Alice's side: LLRs from (softening metric, own symbols) + decode.

        ``x_block`` streams like Bob's y (carry-over boundary handling);
        ``n_hat``/``synd`` must cover the same frames that complete here.
        ``bob_words`` (optional, [F, N]) enables ``bit_errors`` accounting of
        the decoded words against Bob's.  Returns a StreamResult for the
        completed frames.
        """
        x = np.concatenate([self._carry_x,
                            np.asarray(x_block, np.int64).ravel()])
        F = x.size // self.N_symb
        self._carry_x = x[F * self.N_symb:]
        xf = x[: F * self.N_symb].reshape(F, self.N_symb)
        if self.defer:
            # queue x-completed frames and Bob's (n_hat, synd[, words])
            # rows independently (they may arrive at different rates) and
            # decode only full batches from the aligned fronts
            self._aq_x.append(xf)
            n_hat = np.asarray(n_hat)
            if n_hat.shape[0]:
                self._aq_nhat.append(n_hat)
                self._aq_synd.append(synd)
                has_words = bob_words is not None
                if self._aq_words_mode is None:
                    self._aq_words_mode = has_words
                elif self._aq_words_mode != has_words:
                    # both directions desync: starting the accounting
                    # mid-stream aligns later words to earlier queue rows,
                    # stopping it starves the aligned front
                    raise ValueError(
                        "bob_words accounting must be passed on every "
                        "deferred alice_process call or never"
                    )
                if has_words:
                    self._aq_words.append(bob_words)
            avail = min(len(self._aq_x), len(self._aq_nhat),
                        len(self._aq_synd))
            P = (avail // self.batch) * self.batch
            if P == 0:
                return StreamResult()
            return self._alice_run(*self._pop_aligned(P), max_iterations,
                                   leave_pending=True)
        if F == 0:
            return StreamResult()
        n_hat = np.asarray(n_hat)[:F]
        synd = np.asarray(synd)[:F]
        return self._alice_run(n_hat, xf, synd, bob_words, max_iterations)

    def _pop_aligned(self, P):
        """The first ``P`` rows of Alice's aligned queues:
        ``(n_hat, x, synd, bob_words or None)``."""
        return (self._aq_nhat.take(P), self._aq_x.take(P),
                self._aq_synd.take(P),
                self._aq_words.take(P) if self._aq_words_mode else None)

    def alice_flush(self, max_iterations: int = 50):
        """Drain Alice's deferred queues (padded tail batch, once) and any
        pending batch; returns a StreamResult (empty when nothing is queued
        or pending)."""
        avail = min(len(self._aq_x), len(self._aq_nhat), len(self._aq_synd))
        if avail == 0 and self._alice_pending is None:
            return StreamResult()
        return self._alice_run(*self._pop_aligned(avail), max_iterations)

    def _alice_run(self, n_hat, xf, synd, bob_words, max_iterations,
                   leave_pending=False):
        """Batch-blocked LLR+decode of aligned frames [F, ...]."""
        F = xf.shape[0]
        res = StreamResult()

        def harvest(pend):
            (success, iters, total), words_slice, take = pend
            words = _host((total.T < 0).to(torch.uint8)[:take])
            if words_slice is not None:
                res.bit_errors += int(np.sum(words != words_slice))
            res.frames += take
            res.decoded_words.extend(list(words))
            res.success.extend(bool(s) for s in _host(success[:take]))
            res.iterations.extend(int(i) for i in _host(iters[:take]))

        # block r+1 is issued before block r is read back; in defer mode
        # the pending slot persists across calls, and its tuple carries its
        # own bob_words slice, so its frames report in whichever call
        # harvests them
        for lo in range(0, F, self.batch):
            hi = min(lo + self.batch, F)
            self.decode_dispatches += 1
            out = self._alice_round(
                self._upload_y(self._pad(n_hat[lo:hi])),
                self._upload_x(self._pad(xf[lo:hi])),
                torch.from_numpy(np.ascontiguousarray(
                    self._pad(synd[lo:hi]))).to(self.device),
                int(max_iterations),
            )
            # a copy: the pending slot outlives the queue rows it came from
            ws = (np.array(bob_words[lo:hi], np.uint8)
                  if bob_words is not None else None)
            if self._alice_pending is not None:
                harvest(self._alice_pending)
            self._alice_pending = (out, ws, hi - lo)
        if not leave_pending and self._alice_pending is not None:
            harvest(self._alice_pending)
            self._alice_pending = None
        return res

    # -------------------------------------------- device-handoff step pair

    def bob_step(self, y_block) -> DeviceHandoff:
        """Bob's side with device-resident outputs: consume a block of
        Bob's samples and return a :class:`DeviceHandoff` covering the
        full batches that accumulated (it may be empty).

        The same round as :meth:`bob_process` (and the same y carry
        buffer), but nothing is read back: the outputs stay on the device
        for :meth:`alice_step`.  Completed frames queue until a full
        ``batch`` accumulates; :meth:`bob_step_flush` drains the padded
        tail once at the end of the stream.  Not available in defer mode
        (the deferred host queues would desync from the handle's batches).
        """
        if self.defer:
            raise ValueError(
                "bob_step/alice_step require defer=False (bob_step "
                "already queues to full batches; the deferred host "
                "queues would desync from the handle's batches)"
            )
        y = np.concatenate([self._carry_y,
                            np.asarray(y_block, np.float64).ravel()])
        F = y.size // self.N_symb
        self._carry_y = y[F * self.N_symb:]
        self._bob_q.append(y[: F * self.N_symb])
        return self._bob_step_run(
            self._bob_q.take(len(self._bob_q) // self.batch * self.batch))

    def bob_step_flush(self) -> DeviceHandoff:
        """Drain Bob's queued frames into a final (padded) handoff batch;
        an empty handle when nothing is queued."""
        return self._bob_step_run(self._bob_q.take(len(self._bob_q)))

    def _bob_step_run(self, yf) -> DeviceHandoff:
        hand = DeviceHandoff()
        F = yf.shape[0]
        for lo in range(0, F, self.batch):
            hi = min(lo + self.batch, F)
            w, s, nh = self._bob_round(self._upload_y(self._pad(yf[lo:hi])))
            hand.batches.append((w, s, nh, hi - lo))
            hand.frames += hi - lo
        return hand

    def _harvest_packed(self, res, pend):
        """Add a pending fused/handoff batch's outputs to ``res``."""
        (succ, iters, errs, packed), take = pend
        res.frames += take
        res.success.extend(bool(v) for v in _host(succ[:take]))
        res.iterations.extend(int(v) for v in _host(iters[:take]))
        res.bit_errors += int(_host(errs[:take]).sum())
        words = np.unpackbits(_host(packed[:take]), axis=1,
                              bitorder="little")[:, : self.N]
        res.decoded_words.extend(list(words))

    def alice_step(self, handoff: DeviceHandoff, x_block,
                   max_iterations: int = 50) -> StreamResult:
        """Alice's side consuming a :class:`DeviceHandoff`: LLRs + decode
        with Bob's (n_hat, synd, words) on the device end to end.

        ``x_block`` streams like :meth:`alice_process`'s (shared x carry
        buffer) and must complete at least the handoff's frames; excess
        symbols carry over.  Bit errors against Bob's words are counted on
        the device and the decoded words come back bit-packed.  Batches are
        popped from the handle as they are dispatched, so a handle's device
        memory is released batch by batch.  Returns a StreamResult.
        """
        x = np.concatenate([self._carry_x,
                            np.asarray(x_block, np.int64).ravel()])
        Fh = handoff.frames
        if x.size < Fh * self.N_symb:
            # absorb x_block into the carry before raising, so a retry with
            # the missing tail symbols resumes the aligned stream
            self._carry_x = x
            raise ValueError(
                f"x stream completes {x.size // self.N_symb} frames but "
                f"the handoff carries {Fh}"
            )
        self._carry_x = x[Fh * self.N_symb:]
        xf = x[: Fh * self.N_symb].reshape(Fh, self.N_symb)
        res = StreamResult()
        pending = None
        lo = 0
        while handoff.batches:
            w, s, nh, take = handoff.batches.pop(0)
            handoff.frames -= take
            xs = self._pad(xf[lo:lo + take])
            lo += take
            self.decode_dispatches += 1
            out = self._alice_handoff_round(nh, self._upload_x(xs), s, w,
                                            int(max_iterations))
            if pending is not None:
                self._harvest_packed(res, pending)
            pending = (out, take)
        if pending is not None:
            self._harvest_packed(res, pending)
        return res

    # ------------------------------------------------- fused protocol path

    def stream_fused(self, y_stream, x_stream, max_iterations: int = 50):
        """Run the full Bob->Alice reconciliation over chunked streams, one
        device pass per batch (:meth:`_fused_round`): no host round trip of
        Bob's outputs, bit errors against Bob's words counted on the device
        and the decoded words downloaded bit-packed.

        The split ``bob_process``/``alice_process`` API is the protocol's
        host boundary; this is the throughput path for simulation, where
        both streams are visible to one host.  Chunks may be any sizes;
        frames complete when both streams cover them.  A batch is read back
        after the next one was issued; the tail is padded once.  Returns a
        StreamResult with per-frame success/iterations, decoded words and
        bit_errors.  On a mesh every rank must be fed the same streams.
        """
        if isinstance(y_stream, np.ndarray):
            y_stream = [y_stream]
        if isinstance(x_stream, np.ndarray):
            x_stream = [x_stream]
        y_it, x_it = iter(y_stream), iter(x_stream)
        S, B = self.N_symb, self.batch
        need = B * S
        ycar, xcar = _Queue(np.float64), _Queue(np.int64)
        res = StreamResult()
        pending = None

        def dispatch(yb, xb, take):
            nonlocal pending
            self.decode_dispatches += 1
            if self.mesh is None:
                out = self._fused_round(self._upload_y(yb),
                                        self._upload_x(xb),
                                        int(max_iterations))
            else:
                out = self._sharded_fused_round(yb, xb, int(max_iterations))
            if pending is not None:
                self._harvest_packed(res, pending)
            pending = (out, take)

        y_done = x_done = False
        while True:
            # top up: each side ends this block either exhausted or with at
            # least one full batch of symbols
            while len(ycar) < need and not y_done:
                try:
                    ycar.append(next(y_it))
                except StopIteration:
                    y_done = True
            while len(xcar) < need and not x_done:
                try:
                    xcar.append(next(x_it))
                except StopIteration:
                    x_done = True
            avail = min(len(ycar), len(xcar)) // S
            if avail >= B:
                dispatch(ycar.take(need).reshape(B, S),
                         xcar.take(need).reshape(B, S), B)
                continue
            if avail:     # padded tail, once (symbols past the shorter
                # stream's last frame cannot decode)
                dispatch(self._pad(ycar.take(avail * S).reshape(avail, S)),
                         self._pad(xcar.take(avail * S).reshape(avail, S)),
                         avail)
            break
        if pending is not None:
            self._harvest_packed(res, pending)
        return res
