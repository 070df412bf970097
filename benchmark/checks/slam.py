"""`correct` for the SLAM cells: what the timed path produced, held
against the plain reference (benchmark/reference/model.py).

During the window `Capture` keeps references to every extraction's
descriptors (the engine's `_extract_impl`), each under the session and
the drive frame that the loop was feeding when it ran, and, by reservoir
sampling from the seed, references to the inputs and outputs of the
program's own calls: a sample of the extractions (the uploaded points,
the survivors of the filters, the descriptors), of the registrations of
each kind (the decoder's `registration` under the engine's odometry,
scan-to-map and map-to-map entries) and of the loop scorings (the
decoder's `loop_detection`). Each sampled registration and loop scoring
keeps the names of its operands as the SLAM layer gave them to the
engine: scan tokens, or a map tile's members (tokens and poses) and its
centre. Nothing on the device is copied or synchronised in the window.

After the window, the reference works out from the benchmark's own
scans what the program derived, and is compared stage by stage:

- the upload: the raw scan of the frame due at that step,
  voxel-filtered, padded and quantized anew (exact: `input_valid_mismatch`,
  `input_gap_m`);
- the filters: the survivors of the distance crop, outlier and low-pass
  filters (`survivor_flip_share`);
- the encoder, on the program's survivors (the filters' flips are judged
  above, and one flip moves every later FPS pick): the tokens' validity
  and positions (`token_xyz_gap_m`) and features (`desc_relerr`);
- the operands of each sampled registration and loop scoring: a scan is
  the descriptors that the extraction of the frame its token names
  produced; a map tile is its members' descriptors moved by their poses
  relative to the centre (`operand_mismatch`: validity or features that
  differ, or a name that matches no extraction; `operand_xyz_gap_m`);
- registration of each kind, on the program's operands: the verdict of
  the gate the SLAM layer applies to that kind (`reg_gate_flips`) and
  rotation, translation, confidence and rmse (`<kind>.<q>_gap_median`),
  where the reference's verdict accepts it; map-to-map's over every loop
  edge the program's gate took in the window, its operands rebuilt from
  their names (the sample's operands are checked against the same
  names);
- loop scoring, on the program's operands: the overlap probabilities in
  log-odds, the median gap over the sampled batches' scores that the
  reference does not saturate (`loop_logit_gap_median`).

What is taken as given: the pose graph's poses and its choice of map
members and loop candidates (the program's state, whose accuracy each
session's aligned ATE reports).
"""

from __future__ import annotations

import inspect
import math
import threading

import numpy as np
import torch

from benchmark.lib.scans import load_scan
from benchmark.reference import model as refm

KINDS = ("odometry", "scan_to_map", "map_to_map")
QUANTITIES = ("rot", "t", "conf", "rmse")
#: the engine's entries into registration and loop scoring, each with the
#: kind of registration it runs and how its operands are named
ENTRIES = {
    "odometry_step_async": "odometry",
    "register_with_info_async": "odometry",
    "register_with_info_multi_async": "odometry",
    "register_scan_to_map_with_info_async": "scan_to_map",
    "register_map_to_map_with_info_async": "map_to_map",
    "loop_scores_by_token": "loop",
}


class Reservoir:
    """k items drawn uniformly from a stream (Algorithm R), from `rng`."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            self.items[j] = item


def _tile_spec(members, centering):
    """A map tile's name: its members' tokens and poses, and its centre
    (poses copied: the pose graph may move them after the call)."""
    return ("tile", [(int(m[0]), np.array(m[3], np.float64))
                     for m in members], np.array(centering, np.float64))


def _operands(entry: str, args: dict, due: int):
    """-> the operand names of the registrations an engine entry runs, in
    the order it runs them; for loop scoring, (member tokens, new token)."""
    scan = lambda token: ("scan", None if token is None else int(token))
    if entry == "odometry_step_async":
        return [(scan(args.get("cand_token")), ("frame", due))]
    if entry == "register_with_info_async":
        return [(scan(args.get("src_token")), scan(args.get("dst_token")))]
    if entry == "register_with_info_multi_async":
        return [(scan(c[4]), scan(args.get("dst_token")))
                for c in args["cands"]]
    if entry == "register_scan_to_map_with_info_async":
        return [(_tile_spec(args["members"], args["centering_SE3"]),
                 scan(args.get("dst_token")))]
    if entry == "register_map_to_map_with_info_async":
        return [(_tile_spec(args["src_members"], args["src_centering"]),
                 _tile_spec(args["dst_members"], args["dst_centering"]))]
    return ([int(m[0]) for m in args["members"]],
            None if args.get("new_token") is None
            else int(args["new_token"]))


class Capture:
    """Samples the program's calls while `on`; `install` wraps the
    engine's instance attributes, `remove` restores them. The loop calls
    `begin_session` before each session's first frame and sets `due` to
    the frame it feeds."""

    KINDS = KINDS

    def __init__(self, engine, seed: int, k_extract=8, k_reg=16, k_loop=4):
        rng = np.random.default_rng([int(seed) % (1 << 63), 7])
        self.engine = engine
        self.extract = Reservoir(k_extract, rng)
        self.reg = {k: Reservoir(k_reg, rng) for k in KINDS}
        self.loop = Reservoir(k_loop, rng)
        self.on = False
        self.session, self.due = -1, None
        #: (session, frame) -> (descriptors (K, C+3), validity (K,))
        self.outputs = {}
        #: every map-to-map registration of the window: (session, names,
        #: operand rows, pair counts, answer); its operands are not kept
        self.m2m = []
        self._ctx = threading.local()
        self._lock = threading.Lock()

    def begin_session(self) -> None:
        """A new session: the descriptors of earlier sessions that no
        sampled call names are let go."""
        with self._lock:
            self.session += 1
            keep = {k for rec in (*self._sampled(), *self.m2m)
                    for k in _names(rec)}
            self.outputs = {k: v for k, v in self.outputs.items()
                            if k in keep}

    def _sampled(self):
        for r in self.reg.values():
            yield from r.items
        yield from self.loop.items

    def install(self) -> None:
        eng, dec = self.engine, self.engine.decoder
        ext, reg, loop = eng._extract_impl, dec.registration, \
            dec.loop_detection

        def extract_impl(points, valid):
            out = ext(points, valid)
            if self.on and points.shape[0] == 1:
                with self._lock:
                    key = (self.session, self.due)
                    self.outputs[key] = (out[0][0], out[1][0])
                    self.extract.offer((key, points, valid, *out))
            return out

        def registration(src, dst, sv, dv, num_pairs,
                         num_pairs_actual=None):
            out = reg(src, dst, sv, dv, num_pairs, num_pairs_actual)
            if self.on:
                ctx = getattr(self._ctx, "value", None)
                kind, names = "odometry", (None, None)
                if ctx is not None and ctx["kind"] != "loop":
                    kind = ctx["kind"]
                    if ctx["ops"]:
                        names = ctx["ops"].pop(0)
                with self._lock:
                    self.reg[kind].offer(
                        (self.session, names, src, dst, sv, dv, num_pairs,
                         num_pairs_actual, out))
                    if kind == "map_to_map":
                        self.m2m.append((self.session, names, src.shape[0],
                                         dst.shape[0], num_pairs,
                                         num_pairs_actual, out))
            return out

        def loop_detection(src, dst, sv, dv):
            out = loop(src, dst, sv, dv)
            if self.on:
                ctx = getattr(self._ctx, "value", None)
                names = None
                if ctx is not None and ctx["kind"] == "loop":
                    tokens, new = ctx["ops"]
                    b = src.shape[0]
                    names = (tokens[ctx["off"]:ctx["off"] + b], new)
                    ctx["off"] += b
                with self._lock:
                    self.loop.offer((self.session, names, src, dst, sv, dv,
                                     out))
            return out

        eng._extract_impl = extract_impl
        dec.registration = registration
        dec.loop_detection = loop_detection
        for entry, kind in ENTRIES.items():
            setattr(eng, entry, self._named(getattr(eng, entry), entry,
                                            kind))

    def _named(self, fn, entry: str, kind: str):
        sig = inspect.signature(fn)

        def wrapped(*a, **kw):
            if not self.on:
                return fn(*a, **kw)
            b = sig.bind(*a, **kw)
            b.apply_defaults()
            prev = getattr(self._ctx, "value", None)
            self._ctx.value = dict(kind=kind, off=0, ops=_operands(
                entry, b.arguments, self.due))
            try:
                return fn(*a, **kw)
            finally:
                self._ctx.value = prev
        return wrapped

    def remove(self) -> None:
        for name in ("_extract_impl", *ENTRIES):
            self.engine.__dict__.pop(name, None)
        for name in ("registration", "loop_detection"):
            self.engine.decoder.__dict__.pop(name, None)

    def counts(self) -> dict:
        return {"extract": self.extract.seen,
                **{k: r.seen for k, r in self.reg.items()},
                "loop_scoring": self.loop.seen}


def _key(session: int, name):
    """The (session, frame) whose extraction an operand name refers to
    (a token is agent id << 16 | timestep, the frame's index)."""
    if name is None:
        return None
    if name[0] == "frame":
        return (session, name[1])
    if name[0] == "scan":
        return None if name[1] is None else (session, name[1] & 0xFFFF)
    return None


def _names(rec):
    """The (session, frame) keys a sampled call's operands refer to."""
    session, names = rec[0], rec[1]
    if names is None:
        return []
    if isinstance(names[0], list):   # loop scoring: (tokens, new token)
        tokens, new = names
        return [(session, t & 0xFFFF) for t in tokens] + \
            ([] if new is None else [(session, new & 0xFFFF)])
    out = []
    for name in names:
        if name is not None and name[0] == "tile":
            out += [(session, t & 0xFFFF) for t, _ in name[1]]
        else:
            k = _key(session, name)
            if k is not None:
                out.append(k)
    return out


def _expected(session: int, name, rows: int, outputs: dict):
    """What an operand of `rows` rows should hold by its name -> (rows
    (rows, C+3) float64, validity (rows,), tile or not), or None when the
    name matches no extraction of the window."""
    if name is None:
        return None
    if name[0] == "tile":
        _, members, centre = name
        per = [outputs.get((session, t & 0xFFFF)) for t, _ in members]
        if any(p is None for p in per) or not per:
            return None
        k = per[0][0].shape[0]
        if rows % k:
            return None
        s = rows // k
        order = list(range(len(members)))
        if len(members) > s:   # an oversized list keeps those nearest
            order = sorted(order, key=lambda i: np.linalg.norm(
                members[i][1][:3, 3] - centre[:3, 3]))[:s]
        inv_c = np.linalg.inv(centre)
        d = per[0][0]
        out = np.zeros((rows, d.shape[1]), np.float64)
        valid = np.zeros((rows,), bool)
        for j, i in enumerate(order):
            desc = per[i][0].double().cpu().numpy()
            pose = inv_c @ members[i][1]
            blk = slice(j * k, (j + 1) * k)
            out[blk, :-3] = desc[:, :-3]
            out[blk, -3:] = desc[:, -3:] @ pose[:3, :3].T + pose[:3, 3]
            valid[blk] = per[i][1].bool().cpu().numpy()
        return out, valid, True
    key = _key(session, name)
    hit = outputs.get(key) if key is not None else None
    if hit is None or hit[0].shape[0] > rows:
        return None
    desc = hit[0].double().cpu().numpy()
    out = np.zeros((rows, desc.shape[1]), np.float64)
    valid = np.zeros((rows,), bool)
    out[:desc.shape[0]] = desc
    valid[:desc.shape[0]] = hit[1].bool().cpu().numpy()
    return out, valid, False


def _operand_gap(got, got_valid, want):
    """-> (differs: validity, features or a scan's positions differ, or
    the name matches nothing; xyz gap m of a tile's valid tokens)."""
    if want is None:
        return True, 0.0
    rows, valid, tile = want
    g = got.double().cpu().numpy()
    gv = got_valid.bool().cpu().numpy()
    if g.shape != rows.shape or not np.array_equal(gv, valid):
        return True, 0.0
    if not np.array_equal(g[valid, :-3], rows[valid, :-3]):
        return True, 0.0
    gap = float(np.abs(g[valid, -3:] - rows[valid, -3:]).max()) \
        if valid.any() else 0.0
    return (not tile and gap > 0.0), (gap if tile else 0.0)


def _operands_check(regs, loops, outputs):
    """-> (operand_mismatch, operand_xyz_gap_m) over the sampled
    registrations and loop scorings."""
    bad, gap = 0, 0.0
    for session, names, src, dst, sv, dv, *_ in regs:
        for name, x, v in zip(names, (src, dst), (sv, dv)):
            differs, g = _operand_gap(
                x, v, _expected(session, name, x.shape[0], outputs))
            bad += differs
            gap = max(gap, g)
    for session, names, src, dst, sv, dv, _ in loops:
        if names is None:
            bad += 1
            continue
        tokens, new = names
        for b in range(src.shape[0]):
            for name, x, v in ((("scan", tokens[b]) if b < len(tokens)
                                else None, src[b], sv[b]),
                               (("scan", new), dst[b], dv[b])):
                differs, _ = _operand_gap(
                    x, v, _expected(session, name, x.shape[0], outputs))
                bad += differs
    return bad, gap


def _loop_edges(cap, model: dict, device) -> list:
    """The map-to-map registrations of the window whose answer the loop
    gate took (the loop edges the program considered), with their
    operands rebuilt from their names: records in the sample's form. A
    name that matches nothing is left out (the operand check counts such
    names among the sampled calls)."""
    gate = _gates(model)["map_to_map"]
    out = []
    for session, names, m, n, k_s, k_a, res in cap.m2m:
        if not gate(float(res[2]), float(res[3])):
            continue
        ops = [_expected(session, name, rows, cap.outputs)
               for name, rows in zip(names, (m, n))]
        if any(o is None for o in ops):
            continue
        (a, av, _), (b, bv, _) = ops
        t = lambda x, dt: torch.tensor(x, dtype=dt, device=device)
        out.append((session, names, t(a, torch.float32), t(b, torch.float32),
                    t(av, torch.bool), t(bv, torch.bool), k_s, k_a, res))
    return out


def _rot_deg(Ra, Rb) -> float:
    """The angle between two rotations, from the chord (well conditioned
    near zero, where the trace's arccos is not)."""
    chord = float(np.linalg.norm(np.asarray(Ra) - np.asarray(Rb)))
    return math.degrees(2.0 * math.asin(min(1.0, chord / (2.0 * 2 ** 0.5))))


def _extraction(recs, ref: refm.Ref, model: dict, root: str, device,
                controls):
    """-> numbers of the sampled extractions (and of each control). Each
    is held against the upload of the drive frame due at its step."""
    out = {"input_valid_mismatch": 0, "input_gap_m": 0.0,
           "survivor_flip_share": 0.0, "token_mask_mismatch": 0,
           "token_xyz_gap_m": 0.0, "desc_relerr": 0.0}
    ctl = {p: 0.0 for p in controls}
    if not recs:
        return out, ctl, {}
    pad = int(model["tpu"]["encoder_points"])
    voxel = float(model["transforms"]["VoxelSample"]["voxel_size"])
    pts_ref, valid_ref, surv_prog, descs, dvalids = [], [], [], [], []
    for (_, frame), points, valid, desc, dvalid, pv in recs:
        pp = points[0].float().cpu().numpy()
        vv = valid[0].bool().cpu().numpy()
        rp, rv = refm.upload_points(load_scan(root, frame)[0], pad, voxel)
        if not np.array_equal(rv, vv):
            out["input_valid_mismatch"] += 1
        both = rv & vv
        if both.any():
            out["input_gap_m"] = max(out["input_gap_m"], float(
                np.abs(rp[both] - pp[both]).max()))
        pts_ref.append(rp)
        valid_ref.append(rv)
        surv_prog.append(pv[0].bool())
        descs.append(desc[0].float())
        dvalids.append(dvalid[0].bool())
    P = torch.tensor(np.stack(pts_ref), device=device)
    V = torch.tensor(np.stack(valid_ref), device=device)
    norm, surv = refm.preprocess(P, V, model["transforms"])
    SP = torch.stack(surv_prog)
    flips = (surv != SP).sum(1).double() / torch.clamp(surv.sum(1), min=1)
    out["survivor_flip_share"] = float(flips.max())
    scale = float(model["slam_system"]["coor_scale"])
    coor, fea, tv = ref.encode(norm, SP)
    D, DV = torch.stack(descs), torch.stack(dvalids)
    out["token_mask_mismatch"] = int((tv != DV).any(1).sum())
    both = (tv & DV)[..., None]
    xyz_gap = torch.where(both, (coor * scale - D[..., -3:]).abs(),
                          torch.zeros_like(coor))
    out["token_xyz_gap_m"] = float(xyz_gap.max())

    def relerr(a, b):
        a = torch.where(both, a, torch.zeros_like(a))
        b = torch.where(both, b, torch.zeros_like(b))
        return ((a - b).flatten(1).norm(dim=1)
                / torch.clamp(b.flatten(1).norm(dim=1), min=1e-30)).max()

    out["desc_relerr"] = float(relerr(D[..., :-3], fea))
    info = {}
    for prec in controls:
        _, fea_c, _ = refm.Ref(ref.P, ref.m, prec).encode(norm, SP)
        ctl[prec] = float(relerr(fea_c, fea))
        # what `survivor_flip_share` reads where a filter is left out
        for stage in ("OutlierFilter", "LowPassFilter"):
            if stage in model["transforms"]:
                cfg = {k: v for k, v in model["transforms"].items()
                       if k != stage}
                _, s_off = refm.preprocess(P, V, cfg)
                info[f"{stage}_off.survivor_flip_share"] = float(
                    ((s_off != surv).sum(1).double()
                     / torch.clamp(surv.sum(1), min=1)).max())
    return out, ctl, info


def _gates(model: dict) -> dict:
    """Each kind's verdict as the SLAM layer takes it from (confidence,
    rmse): an odometry edge is dropped below `edge_confidence_drop` or
    above `edge_rmse_drop`, a scan-to-map adjustment is kept within
    `edge_rmse_drop`, a loop edge is kept from
    `loop_detection_confidence_acpt_threshold` up."""
    ss = model["slam_system"]
    conf_drop = float(ss["edge_confidence_drop"])
    rmse_drop = float(ss["edge_rmse_drop"])
    loop_conf = float(ss["loop_detection_confidence_acpt_threshold"])
    return {"odometry": lambda c, r: c >= conf_drop and r <= rmse_drop,
            "scan_to_map": lambda c, r: r <= rmse_drop,
            "map_to_map": lambda c, r: c >= loop_conf}


def _registration(by_kind, edges, ref: refm.Ref, model: dict, controls):
    """Each sampled registration against the reference on its operands.
    A registration's answer is its kind's gate verdict (`_gates`) and,
    where the reference's verdict accepts it, its pose, confidence and
    rmse: a rejected registration (scans that do not overlap) is dropped
    whatever pose it gives, and rounding moves its RANSAC consensus
    anywhere. The loop gate passes too few of a random sample of
    map-to-map registrations (0-2 of 16) to judge on, so that kind's gaps
    are taken over the loop edges of the window (`edges`: every
    map-to-map registration whose answer the program's loop gate took)
    and its sample counts only in the verdicts. -> numbers: pair count
    mismatches, gate verdicts that differ, and for each kind the median
    of each gap."""
    who = ("program",) + tuple(controls)
    gaps = {w: {k: {q: [] for q in QUANTITIES} for k in KINDS} for w in who}
    flips = {w: 0 for w in who}
    mismatch = 0
    ss = model["slam_system"]
    tau = float(model["loss"]["tau"])
    eps = float(model["loss"]["eps_offset"])
    robust = bool(model["tpu"].get("robust_register", False))
    ns = float(ss.get("registration_sample_odometer", 0.5))
    gates = _gates(model)
    as_np = lambda res: [x.double().cpu().numpy() for x in res[:4]]

    def add(w, kind, a, b, gaps_too):
        accept = lambda r: gates[kind](float(r[2]), float(r[3]))
        flips[w] += accept(a) != accept(b)
        if not (gaps_too and accept(b)):
            return
        g = gaps[w][kind]
        g["rot"].append(_rot_deg(a[0], b[0]))
        g["t"].append(float(np.linalg.norm(a[1] - b[1])))
        g["conf"].append(float(abs(a[2] - b[2])))
        g["rmse"].append(float(abs(a[3] - b[3])))

    runs = [(k, r, k != "map_to_map") for k in KINDS for r in by_kind[k]]
    runs += [("map_to_map", r, True) for r in edges]
    for kind, rec, gaps_too in runs:
        _, _, src, dst, sv, dv, k_static, k_actual, res = rec
        m, n = src.shape[0], dst.shape[0]
        k_s = refm.num_pairs_for(m, n, ns)
        k_a = refm.num_pairs_for(int(sv.sum()), int(dv.sum()), ns)
        if k_s != int(k_static) or (k_actual is not None
                                    and k_a != int(k_actual)):
            mismatch += 1
        args = (src.float(), dst.float(), sv.bool(), dv.bool(), k_s,
                k_a, tau, eps, robust)
        want = as_np(ref.registration(*args))
        add("program", kind, as_np(res), want, gaps_too)
        for prec in controls:
            add(prec, kind, as_np(refm.Ref(ref.P, ref.m, prec)
                                  .registration(*args)), want, gaps_too)
    med = lambda v: float(np.median(v)) if v else 0.0

    def medians(w):
        return {f"{k}.{q}_gap_median": med(gaps[w][k][q])
                for k in KINDS for q in QUANTITIES}

    out = dict(reg_pairs_mismatch=mismatch, reg_gate_flips=flips["program"],
               **medians("program"))
    info = {f"{k}.accepted": len(gaps["program"][k]["rot"]) for k in KINDS}
    info["loop_edges"] = len(edges)
    info.update({f"{k}.{q}_gap_max": max(gaps["program"][k][q], default=0.0)
                 for k in KINDS for q in ("rot", "t")})
    ctl = {p: dict(reg_gate_flips=flips[p], **medians(p)) for p in controls}
    return out, ctl, info


def _logit(p: torch.Tensor) -> torch.Tensor:
    """Log-odds of probabilities clipped to [1e-6, 1 - 1e-6]: a saturated
    overlap reads as saturated on both sides, an open one by its score."""
    p = torch.clamp(p.double(), 1e-6, 1 - 1e-6)
    return torch.log(p) - torch.log1p(-p)


def _loops(recs, ref: refm.Ref, controls):
    """The gaps in log-odds between the program's overlap probabilities
    and the reference's, over the scores of the sampled batches that the
    reference leaves inside the clip (a saturated score reads 0 on any
    side, and the share of those follows the drive, not the precision)
    -> (median, worst, {precision: median} of the controls). A sample's
    worst score swings by its nature (one score near the head's steepest
    point); the median separates the precisions."""
    gaps, cgaps = [], {p: [] for p in controls}
    for _, _, src, dst, sv, dv, probs in recs:
        args = (src.float(), dst.float(), sv.bool(), dv.bool())
        p = ref.loop_prob(*args).double()
        open_ = (p > 1e-6) & (p < 1 - 1e-6)
        want = _logit(p)
        gaps += (want - _logit(probs))[open_].abs().tolist()
        for prec in controls:
            got = _logit(refm.Ref(ref.P, ref.m, prec).loop_prob(*args))
            cgaps[prec] += (want - got)[open_].abs().tolist()
    med = lambda v: float(np.median(v)) if v else 0.0
    return med(gaps), max(gaps, default=0.0), {p: med(v)
                                               for p, v in cgaps.items()}


@torch.no_grad()
def compare(cap: Capture, tree: dict, model: dict, root: str,
            device, controls=()) -> tuple:
    """-> (numbers {name: value}, control numbers {prec: {name: value}},
    sample sizes). `tree`: the reference's parameters on `device`;
    `root`: the drive as the loop fed it (frame i is `root`/i.npz)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = refm.Ref(tree, model, "f32")
    nums, ext_ctl, ext_info = _extraction(cap.extract.items, ref, model,
                                          root, device, controls)
    by_kind = {k: cap.reg[k].items for k in KINDS}
    regs = [r for k in KINDS for r in by_kind[k]]
    nums["operand_mismatch"], nums["operand_xyz_gap_m"] = _operands_check(
        regs, cap.loop.items, cap.outputs)
    reg_nums, reg_ctl, reg_info = _registration(
        by_kind, _loop_edges(cap, model, device), ref, model, controls)
    nums.update(reg_nums)
    nums["loop_logit_gap_median"], loop_worst, loop_ctl = _loops(
        cap.loop.items, ref, controls)
    reg_info["loop_logit_gap_max"] = loop_worst
    ctl = {p: dict(desc_relerr=ext_ctl[p], loop_logit_gap_median=loop_ctl[p],
                   **reg_ctl[p]) for p in controls}
    sizes = {"extract": len(cap.extract.items),
             **{k: len(cap.reg[k].items) for k in KINDS},
             "loop_scoring": len(cap.loop.items)}
    return nums, ctl, dict(sizes, **reg_info, **ext_info)
