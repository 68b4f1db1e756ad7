"""Training drivers for ADMMNet (end-to-end) and PhiEstADMMNet (phi
regression).

Parity targets:
- ``train_admmnet``  ~ reference train.py:13-450 -- AdamW + SGDR restarts,
  param groups (ADMM layers at 0.5x lr, train.py:107-121), global grad-norm
  clip 1.0, best-on-val checkpointing + resume, early stop (patience 10),
  per-epoch history JSON, final test with count-based precision/recall/F1 at
  confidence > 0.5 (train.py:381-426);
- ``train_phinet``   ~ reference trainPhi.py:12-311 -- same skeleton against
  PhiAlignmentLoss on classical-solver phi labels.

Deltas: one jitted train step (no .item() graph breaks inside the epoch),
batched metric computation, and a ``mesh`` option that shards the batch axis data-parallel over the devices
(gradients reduce via the psum emitted by jit-with-sharding; the reference is
strictly single-device, SURVEY.md 2.2).

Mesh semantics: params/opt_state are replicated, every batch's leading axis
is sharded over the mesh's ``data`` axis, and eval metrics are computed
on-device (replicated scalars), so the same loop runs single-device,
multi-device, and multi-process (``jax.distributed``) -- checkpoint/metric
file writes are gated on process 0.  Batches must divide evenly over the
``data`` axis, so remainder minibatches are dropped when a mesh is given
(pass a batch size that divides the split sizes to use every sample).
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from admmnet_tpu.core.config import ModelConfig, TrainConfig
from admmnet_tpu.data.generator import iterate_batches
from admmnet_tpu.models import ADMMNet, PhiEstADMMNet
from admmnet_tpu.train.checkpoint import restore_checkpoint, save_checkpoint
from admmnet_tpu.train.losses import basic_anm_loss, phi_alignment_loss
from admmnet_tpu.train.metrics_io import MetricsWriter
from admmnet_tpu.train.schedules import sgdr_schedule


def param_group_labels(params, admm_modules: Tuple[str, ...]):
    """Label every param leaf "admm" (scaled LR) or "other" (full LR).

    BOTH reference trainers put the unrolled-ADMM-layer params in a
    0.5x-lr group: train.py:107-121 AND trainPhi.py:105-113 build
    ``param_groups.append({'params': admm_params, 'lr': config['lr'] * 0.5})``
    from the ``phiLayers/hLayers/gLayers/zLayers`` name prefixes.  For
    ``PhiEstADMMNet`` every parameter matches those prefixes, so the
    reference's phi training runs the WHOLE model at an effective
    ``0.5 * lr`` -- reproduced here because the trunk is the whole model.

    ``admm_modules`` comes from the model class's ``ADMM_LR_MODULES``
    declaration (models/nets.py) rather than a literal name in the trainer,
    so a module rename updates both sides together; an ``admm_modules``
    entry that matches no param subtree raises instead of silently
    reshuffling LR groups.
    """
    admm_modules = tuple(admm_modules)

    def label(path, _leaf) -> str:
        keys = {getattr(p, "key", None) for p in path}
        return "admm" if keys & set(admm_modules) else "other"

    labels = jax.tree_util.tree_map_with_path(label, params)
    present = set(jax.tree_util.tree_leaves(labels))
    if admm_modules and "admm" not in present:
        top = sorted(params.get("params", params))
        raise ValueError(
            f"ADMM LR-group modules {admm_modules} matched no params; "
            f"model has top-level modules {top}"
        )
    return labels


def make_optimizer(
    tcfg: TrainConfig,
    steps_per_epoch: int,
    admm_modules: Tuple[str, ...] = ("trunk",),
):
    sched = sgdr_schedule(
        tcfg.lr, steps_per_epoch, tcfg.epochs, tcfg.sgdr_t0, tcfg.sgdr_t_mult,
        tcfg.lr_min,
    )

    def adamw(scale):
        return optax.adamw(
            lambda step: scale * sched(step), weight_decay=tcfg.weight_decay
        )

    return optax.chain(
        optax.clip_by_global_norm(tcfg.grad_clip),
        optax.multi_transform(
            {"admm": adamw(tcfg.admm_lr_scale), "other": adamw(1.0)},
            param_labels=lambda params: param_group_labels(params, admm_modules),
        ),
    )


@dataclasses.dataclass
class TrainResult:
    params: Any
    history: Dict[str, list]
    best_val_loss: float
    test_metrics: Dict[str, float]
    epochs_run: int


def _detection_counts(conf: np.ndarray, L_true: np.ndarray, thr: float):
    """Count-based detection protocol (reference train.py:381-392)."""
    detected = np.sum(conf > thr, axis=-1)
    L = L_true.astype(int)
    tp = np.sum(np.minimum(L, detected) * ((L > 0) & (detected > 0)))
    fp = np.sum(np.maximum(detected - L, 0))
    fn = np.sum(np.maximum(L - detected, 0))
    return int(tp), int(fp), int(fn)


def _masked_rmse(pred, true, L_true):
    """Per-sample masked RMSE, averaged (reference train.py:262-282)."""
    L_max = pred.shape[-1]
    mask = np.arange(L_max)[None, :] < L_true[:, None]
    cnt = np.maximum(L_true, 1)
    mse = np.sum(mask * (pred - true) ** 2, axis=-1) / cnt
    rmse = np.sqrt(mse)
    sel = L_true > 0
    return float(np.mean(rmse[sel])) if np.any(sel) else 0.0


def _matched_rmse_pair(tau_pred, f_pred, tau_true, f_true, L_true):
    """(tau_rmse, f_rmse) under the per-sample best slot->target assignment.

    Metric counterpart of ``permutation_matched_parameter_loss``: when the
    model is trained with set matching (``assignment="perm"``), slot-paired
    RMSE (the reference's train.py:262-282 convention) mispairs and inflates
    the error, so eval must score under the same matching as the loss.  The
    permutation is chosen to minimize the combined masked tau+f MSE (the
    loss's criterion), then both RMSEs are reported under it.
    """
    import itertools

    B, L_max = tau_pred.shape
    perms = np.array(list(itertools.permutations(range(L_max))))  # (P, L_max)
    mask = (np.arange(L_max)[None, :] < L_true[:, None]).astype(tau_pred.dtype)
    cnt = np.maximum(L_true, 1).astype(tau_pred.dtype)
    tau_p = tau_pred[:, perms]  # (B, P, L_max)
    f_p = f_pred[:, perms]
    tau_mse = np.sum(mask[:, None, :] * (tau_p - tau_true[:, None, :]) ** 2,
                     axis=-1) / cnt[:, None]
    f_mse = np.sum(mask[:, None, :] * (f_p - f_true[:, None, :]) ** 2,
                   axis=-1) / cnt[:, None]
    best = np.argmin(tau_mse + f_mse, axis=-1)  # (B,)
    rows = np.arange(B)
    sel = L_true > 0
    if not np.any(sel):
        return 0.0, 0.0
    tau_rmse = np.sqrt(tau_mse[rows, best])[sel]
    f_rmse = np.sqrt(f_mse[rows, best])[sel]
    return float(np.mean(tau_rmse)), float(np.mean(f_rmse))


def _detection_counts_dev(conf, L_true, thr):
    """jnp version of :func:`_detection_counts`; replicated int scalars, so
    the counts work under mesh sharding and multi-process without fetching
    per-sample arrays to host."""
    detected = jnp.sum(conf > thr, axis=-1)
    L = L_true.astype(jnp.int32)
    tp = jnp.sum(jnp.minimum(L, detected) * ((L > 0) & (detected > 0)))
    fp = jnp.sum(jnp.maximum(detected - L, 0))
    fn = jnp.sum(jnp.maximum(L - detected, 0))
    return tp, fp, fn


def _masked_rmse_dev(pred, true, L_true):
    """jnp version of :func:`_masked_rmse` (same per-batch mean semantics)."""
    L_max = pred.shape[-1]
    mask = jnp.arange(L_max)[None, :] < L_true[:, None]
    cnt = jnp.maximum(L_true, 1)
    mse = jnp.sum(mask * (pred - true) ** 2, axis=-1) / cnt
    rmse = jnp.sqrt(mse)
    sel = L_true > 0
    return jnp.sum(rmse * sel) / jnp.maximum(jnp.sum(sel), 1)


def _matched_rmse_pair_dev(tau_pred, f_pred, tau_true, f_true, L_true):
    """jnp version of :func:`_matched_rmse_pair` (best-assignment RMSEs)."""
    import itertools

    L_max = tau_pred.shape[-1]
    perms = jnp.asarray(list(itertools.permutations(range(L_max))))  # (P, L)
    mask = (jnp.arange(L_max)[None, :] < L_true[:, None]).astype(tau_pred.dtype)
    cnt = jnp.maximum(L_true, 1).astype(tau_pred.dtype)
    tau_p = tau_pred[:, perms]  # (B, P, L)
    f_p = f_pred[:, perms]
    tau_mse = jnp.sum(mask[:, None, :] * (tau_p - tau_true[:, None, :]) ** 2,
                      axis=-1) / cnt[:, None]
    f_mse = jnp.sum(mask[:, None, :] * (f_p - f_true[:, None, :]) ** 2,
                    axis=-1) / cnt[:, None]
    best = jnp.argmin(tau_mse + f_mse, axis=-1)  # (B,)
    tau_rmse = jnp.sqrt(jnp.take_along_axis(tau_mse, best[:, None], 1))[:, 0]
    f_rmse = jnp.sqrt(jnp.take_along_axis(f_mse, best[:, None], 1))[:, 0]
    sel = L_true > 0
    denom = jnp.maximum(jnp.sum(sel), 1)
    return jnp.sum(tau_rmse * sel) / denom, jnp.sum(f_rmse * sel) / denom


def _matched_detection_dev(tau_pred, f_pred, conf, tau_true, f_true, L_true,
                           tol, thr):
    """Location-matched detection counts as device scalars (greedy matching,
    the ``peaks.metrics.match_peaks`` protocol applied to the trainer's slot
    predictions).

    The reference's count-based protocol (train.py:381-392, kept as the
    parity metric) is degenerate when ``L_true == L_max`` for every sample
    and conf > thr near-always: any head -- including a mean-collapsed one --
    scores F1 1.0.  This matched variant makes a prediction a true positive
    only if it falls within ``tol`` of an unmatched true target, so a
    collapsed head can no longer self-certify (round-3 verdict, weak-7).

    Returns (tp, fp, fn, tau_sse, f_sse) so RMSE over matched pairs
    aggregates across batches in the caller.  Works under mesh sharding
    (replicated scalars) like the other _dev metrics.
    """
    K = tau_pred.shape[-1]
    L = tau_true.shape[-1]
    valid_pred = conf > thr  # (B, K)
    used = jnp.zeros(valid_pred.shape, bool)
    tp = jnp.zeros((), jnp.int32)
    fn = jnp.zeros((), jnp.int32)
    tau_sse = jnp.zeros((), jnp.float32)
    f_sse = jnp.zeros((), jnp.float32)
    for l in range(L):  # L is small and static (L_max slots); unrolled
        t_valid = l < L_true.astype(jnp.int32)  # (B,)
        dt = jnp.abs(tau_pred - tau_true[:, l:l + 1])  # (B, K)
        df = jnp.abs(f_pred - f_true[:, l:l + 1])
        ok = valid_pred & ~used & (dt <= tol) & (df <= tol)
        d = jnp.where(ok, dt**2 + df**2, jnp.inf)
        j = jnp.argmin(d, axis=-1)  # (B,)
        hit = jnp.take_along_axis(ok, j[:, None], -1)[:, 0] & t_valid
        used = used | ((jax.nn.one_hot(j, K, dtype=jnp.bool_)) & hit[:, None])
        tp += jnp.sum(hit)
        fn += jnp.sum(t_valid & ~hit)
        dtj = jnp.take_along_axis(dt, j[:, None], -1)[:, 0]
        dfj = jnp.take_along_axis(df, j[:, None], -1)[:, 0]
        tau_sse += jnp.sum(jnp.where(hit, dtj**2, 0.0))
        f_sse += jnp.sum(jnp.where(hit, dfj**2, 0.0))
    fp = jnp.sum(valid_pred & ~used)
    return tp, fp, fn, tau_sse, f_sse


# position-matched test-metric tolerance: the accuracy protocol used
# everywhere else in the repo (peaks/metrics.py, eval_net, RESULTS.md)
MATCH_TOL = 0.05


def train_admmnet(
    mcfg: ModelConfig,
    tcfg: TrainConfig,
    train_data: Dict[str, np.ndarray],
    val_data: Dict[str, np.ndarray],
    test_data: Optional[Dict[str, np.ndarray]] = None,
    workdir: str = "runs/admmnet",
    log_fn: Callable[[str], None] = print,
    init_from: Optional[str] = None,
    mesh=None,
) -> TrainResult:
    """``init_from``: warm-start matching submodules (e.g. the unrolled
    "trunk") from another run's checkpoint -- typically a trained
    PhiEstADMMNet, mirroring the reference's deployment of the phi net
    (main_for_net.py:99-104) -- before e2e fine-tuning.  Ignored when the
    workdir already has a checkpoint to resume.

    ``mesh``: optional ``jax.sharding.Mesh`` (e.g. ``parallel.data_mesh()``)
    for data-parallel training: batch axis sharded over the ``data`` mesh
    axis, params replicated, grads psum-reduced by jit."""
    model = ADMMNet(cfg=mcfg)
    return _train_loop(
        model, mcfg, tcfg, train_data, val_data, test_data, workdir, log_fn,
        mode="e2e", init_from=init_from, mesh=mesh,
    )


def train_phinet(
    mcfg: ModelConfig,
    tcfg: TrainConfig,
    train_data: Dict[str, np.ndarray],
    val_data: Dict[str, np.ndarray],
    test_data: Optional[Dict[str, np.ndarray]] = None,
    workdir: str = "runs/phinet",
    log_fn: Callable[[str], None] = print,
    mesh=None,
) -> TrainResult:
    if "phi" not in train_data:
        raise ValueError("phi labels required; generate dataset with with_phi=True")
    model = PhiEstADMMNet(cfg=mcfg)
    return _train_loop(
        model, mcfg, tcfg, train_data, val_data, test_data, workdir, log_fn,
        mode="phi", mesh=mesh,
    )


def build_steps(
    model, tx, mode: str, assignment: str = "slot",
    spectral_weight: float = 0.0, conf_threshold: float = 0.5,
):
    """Build (train_step, eval_step) pure functions for ``model``.

    ``mode``: "e2e" (ADMMNet + BasicANMLoss) or "phi" (PhiEstADMMNet +
    PhiAlignmentLoss).  train_step: (params, opt_state, batch, dropout_key)
    -> (params, opt_state, total_loss); eval_step: (params, batch) ->
    (total_loss, metrics) where metrics are device SCALARS (per-batch
    tau/f RMSE under ``assignment`` matching plus tp/fp/fn detection counts
    for "e2e"; empty for "phi") so eval works identically on one device, a
    sharded mesh, and multi-process runs.  Shared by the trainer, the mesh
    dry-run, and the graft entry.
    """

    def loss_and_metrics(p, batch, dropout_key, deterministic):
        if mode == "e2e":
            tau, f, conf, phi = model.apply(
                p, batch["y"], batch["b"], batch["sigma"],
                deterministic=deterministic,
                rngs=None if deterministic else {"dropout": dropout_key},
            )
            total, parts = basic_anm_loss(
                tau, f, conf, phi, batch["tau"], batch["f"], batch["L_true"],
                assignment=assignment,
                spectral_weight=spectral_weight,
                spec=model.cfg.spec,
            )
            aux = {"tau": tau, "f": f, "conf": conf}
        else:
            phi = model.apply(
                p, batch["y"], batch["b"], batch["sigma"],
                deterministic=deterministic,
            )
            total, parts = phi_alignment_loss(phi, batch["phi"])
            aux = {}
        return total, (parts, aux)

    def train_step(p, o, batch, dropout_key):
        (total, _), grads = jax.value_and_grad(loss_and_metrics, has_aux=True)(
            p, batch, dropout_key, False
        )
        updates, o = tx.update(grads, o, p)
        p = optax.apply_updates(p, updates)
        return p, o, total

    def eval_step(p, batch):
        total, (parts, aux) = loss_and_metrics(p, batch, None, True)
        metrics = {}
        if mode == "e2e":
            if assignment == "perm":
                t_rm, f_rm = _matched_rmse_pair_dev(
                    aux["tau"], aux["f"], batch["tau"], batch["f"],
                    batch["L_true"],
                )
            else:
                t_rm = _masked_rmse_dev(aux["tau"], batch["tau"], batch["L_true"])
                f_rm = _masked_rmse_dev(aux["f"], batch["f"], batch["L_true"])
            tp, fp, fn = _detection_counts_dev(
                aux["conf"], batch["L_true"], conf_threshold
            )
            mtp, mfp, mfn, m_tau_sse, m_f_sse = _matched_detection_dev(
                aux["tau"], aux["f"], aux["conf"], batch["tau"], batch["f"],
                batch["L_true"], MATCH_TOL, conf_threshold,
            )
            metrics = {"tau_rmse": t_rm, "f_rmse": f_rm,
                       "tp": tp, "fp": fp, "fn": fn,
                       "mtp": mtp, "mfp": mfp, "mfn": mfn,
                       "m_tau_sse": m_tau_sse, "m_f_sse": m_f_sse}
        return total, metrics

    return train_step, eval_step


def _batches(data, batch_size, shuffle, seed, drop_remainder=False):
    """Minibatch stream: native C++ prefetch loader when available
    (data/loader.py), else the numpy iterator."""
    try:
        from admmnet_tpu.data.loader import PrefetchLoader, native_available

        if native_available():
            return PrefetchLoader(data, batch_size, shuffle=shuffle, seed=seed,
                                  drop_remainder=drop_remainder)
    except Exception:
        pass
    return iterate_batches(data, batch_size, shuffle=shuffle, seed=seed,
                           drop_remainder=drop_remainder)


def _graft_params(params, donor, log_fn):
    """Replace submodule trees of ``params`` with same-named, same-shaped
    trees from ``donor``, recursing into partially-matching modules.

    Recursion handles architecture supersets: e.g. a ``learned_sensing``
    trunk has an extra ``sensing`` submodule the donor (trained without
    sensing) lacks -- the shared phi/h/g/z layers graft, the sensing matrix
    keeps its fresh (identity) init.  A same-named leaf with a different
    shape raises."""
    import jax

    taken, kept = [], []

    def merge(tgt, src, path):
        if isinstance(tgt, dict) and isinstance(src, dict):
            out = dict(tgt)
            for k, v in src.items():
                if k in tgt:
                    out[k] = merge(tgt[k], v, f"{path}/{k}")
            for k in tgt:
                if k not in src:
                    kept.append(f"{path}/{k}")
            return out
        tgt_shape = jnp.shape(tgt)
        src_shape = tuple(np.shape(src))
        if tgt_shape != src_shape:
            raise ValueError(
                f"init_from leaf {path} shape mismatch: "
                f"{src_shape} vs {tgt_shape}"
            )
        taken.append(path)
        return jnp.asarray(src)

    inner = params["params"]
    donor_inner = donor.get("params", donor)
    grafted = {
        k: merge(inner[k], v, k) for k, v in donor_inner.items() if k in inner
    }
    if not taken:
        raise ValueError("init_from checkpoint shares no submodules with model")
    mods = sorted({p.split("/")[0] for p in taken})
    log_fn(f"warm-started {len(taken)} leaves in submodules {mods} from "
           f"init_from checkpoint"
           + (f"; fresh-init kept for {kept}" if kept else ""))
    out = dict(params)
    out["params"] = {**dict(inner), **grafted}
    return out


class _NullMetrics:
    """No-op metrics sink for non-main processes (mesh/multi-process runs)."""

    def log(self, *a, **k):
        pass

    def write_history(self, h):
        pass

    def write_test_result(self, m):
        pass


def _train_loop(
    model, mcfg, tcfg, train_data, val_data, test_data, workdir, log_fn, mode,
    init_from=None, mesh=None,
):
    is_main = jax.process_index() == 0
    workdir = Path(workdir)
    if is_main:
        workdir.mkdir(parents=True, exist_ok=True)
        metrics = MetricsWriter(workdir)
    else:
        metrics = _NullMetrics()

        def log_fn(msg):  # noqa: F811 -- quiet non-main processes
            del msg
    n_train = train_data["y"].shape[0]
    steps_per_epoch = max(1, n_train // tcfg.batch_size)
    tx = make_optimizer(
        tcfg, steps_per_epoch,
        admm_modules=getattr(type(model), "ADMM_LR_MODULES", ("trunk",)),
    )

    rng = jax.random.PRNGKey(tcfg.seed)
    init_b = {k: v[:2] for k, v in train_data.items()}
    params = jax.jit(lambda key, y, b, s: model.init(key, y, b, s))(
        rng, init_b["y"], init_b["b"], init_b["sigma"]
    )
    opt_state = tx.init(params)

    assignment = getattr(tcfg, "assignment", "slot")
    train_step, eval_step = build_steps(
        model, tx, mode, assignment=assignment,
        spectral_weight=getattr(tcfg, "spectral_weight", 0.0),
        conf_threshold=tcfg.conf_threshold,
    )

    # mesh data parallelism: params/opt_state replicated, batch axis sharded
    # over 'data', grads psum-reduced by the partitioner; remainder
    # minibatches are dropped so shards stay equal-sized.
    jit_train_kw, jit_eval_kw = {}, {}
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from admmnet_tpu.parallel.mesh import replicate, shard_batch

        rep = NamedSharding(mesh, P())
        jit_train_kw = {"out_shardings": (rep, rep, rep)}
        jit_eval_kw = {"out_shardings": (rep, rep)}

        def place_batch(b):
            return shard_batch(b, mesh)

        def place_state(p, o):
            return replicate(p, mesh), replicate(o, mesh)
    else:
        def place_batch(b):
            return b

        def place_state(p, o):
            return p, o

    train_step_j = jax.jit(train_step, **jit_train_kw)
    eval_step_j = jax.jit(eval_step, **jit_eval_kw)

    # resume (reference train.py:136-145)
    start_epoch, best_val, patience_ct = 0, float("inf"), 0
    history = {"train_loss": [], "val_loss": [], "tau_rmse": [], "f_rmse": [], "lr": []}
    restored = restore_checkpoint(workdir, {"params": params, "opt_state": opt_state})
    if restored is None and init_from is not None:
        import flax.serialization as fser

        raw = fser.msgpack_restore(
            (Path(init_from) / "best_model.msgpack").read_bytes()
        )
        params = _graft_params(params, raw["params"], log_fn)
        opt_state = tx.init(params)
    if restored is not None:
        state, meta = restored
        params, opt_state = state["params"], state["opt_state"]
        start_epoch = meta["epoch"] + 1
        best_val = meta["best_val_loss"]
        history = meta.get("history", history)
        if getattr(tcfg, "reset_best", False):
            # curriculum stage switch: val losses are not comparable across
            # datasets; keep params/epoch, forget the old best
            best_val = float("inf")
        log_fn(f"resumed from epoch {start_epoch}"
               + (" (best_val reset)" if best_val == float("inf") else ""))
    params, opt_state = place_state(params, opt_state)

    sched_probe = sgdr_schedule(
        tcfg.lr, steps_per_epoch, tcfg.epochs, tcfg.sgdr_t0, tcfg.sgdr_t_mult,
        tcfg.lr_min,
    )

    step = start_epoch * steps_per_epoch
    epochs_run = start_epoch
    for epoch in range(start_epoch, tcfg.epochs):
        epochs_run = epoch + 1
        t_ep = time.time()
        tr_losses = []
        for bi, batch in enumerate(
            _batches(train_data, tcfg.batch_size, shuffle=True,
                     seed=tcfg.seed + epoch, drop_remainder=mesh is not None)
        ):
            dk = jax.random.fold_in(rng, step)
            params, opt_state, total = train_step_j(
                params, opt_state, place_batch(batch), dk
            )
            tr_losses.append(total)
            step += 1
        tr_loss = float(np.mean(jax.device_get(tr_losses))) if tr_losses else 0.0

        # validation
        va_losses, tau_es, f_es = [], [], []
        for batch in _batches(val_data, tcfg.batch_size, shuffle=False, seed=0,
                              drop_remainder=mesh is not None):
            total, m = eval_step_j(params, place_batch(batch))
            va_losses.append(float(total))
            if mode == "e2e":
                tau_es.append(float(m["tau_rmse"]))
                f_es.append(float(m["f_rmse"]))
        va_loss = float(np.mean(va_losses)) if va_losses else 0.0

        history["train_loss"].append(tr_loss)
        history["val_loss"].append(va_loss)
        history["tau_rmse"].append(float(np.mean(tau_es)) if tau_es else 0.0)
        history["f_rmse"].append(float(np.mean(f_es)) if f_es else 0.0)
        history["lr"].append(float(sched_probe(step)))
        metrics.log(
            "epoch", epoch=epoch + 1, train_loss=tr_loss, val_loss=va_loss,
            tau_rmse=history["tau_rmse"][-1], f_rmse=history["f_rmse"][-1],
            lr=history["lr"][-1],
        )

        log_fn(
            f"epoch {epoch + 1}/{tcfg.epochs} {time.time() - t_ep:.1f}s "
            f"train {tr_loss:.6f} val {va_loss:.6f} "
            f"tau_rmse {history['tau_rmse'][-1]:.6f} f_rmse {history['f_rmse'][-1]:.6f}"
        )

        if va_loss < best_val:
            best_val = va_loss
            patience_ct = 0
            if is_main:  # process-0-gated IO (multi-process runs)
                save_checkpoint(
                    workdir,
                    jax.device_get({"params": params, "opt_state": opt_state}),
                    {"epoch": epoch, "best_val_loss": best_val,
                     "history": history, "mode": mode},
                )
        else:
            patience_ct += 1
        metrics.write_history(history)
        if patience_ct >= tcfg.patience:
            log_fn(f"early stop at epoch {epoch + 1}")
            break

    # reload best for testing (reference train.py:336-338); the checkpoint is
    # written by process 0 -- multi-process runs require a SHARED workdir so
    # every process reloads the same bytes.  The barrier keeps the reload
    # symmetric: without it a faster non-main process can reach this point
    # before process 0 finished writing, see a missing checkpoint, and skip
    # the (collective) device_put that replicates the restored params --
    # deadlocking process 0.
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("admmnet_final_ckpt")
    restored = restore_checkpoint(workdir, {"params": params, "opt_state": opt_state})
    if restored is not None:
        params, _ = place_state(restored[0]["params"], opt_state)

    test_metrics: Dict[str, float] = {}
    if test_data is not None:
        te_losses, tau_es, f_es = [], [], []
        tp = fp = fn = 0
        mtp = mfp = mfn = 0
        m_tau_sse = m_f_sse = 0.0
        for batch in _batches(test_data, tcfg.batch_size, shuffle=False, seed=0,
                              drop_remainder=mesh is not None):
            total, m = eval_step_j(params, place_batch(batch))
            te_losses.append(float(total))
            if mode == "e2e":
                tau_es.append(float(m["tau_rmse"]))
                f_es.append(float(m["f_rmse"]))
                tp += int(m["tp"])
                fp += int(m["fp"])
                fn += int(m["fn"])
                mtp += int(m["mtp"])
                mfp += int(m["mfp"])
                mfn += int(m["mfn"])
                m_tau_sse += float(m["m_tau_sse"])
                m_f_sse += float(m["m_f_sse"])

        def _prf(tp_, fp_, fn_):
            precision = tp_ / (tp_ + fp_) if tp_ + fp_ else 0.0
            recall = tp_ / (tp_ + fn_) if tp_ + fn_ else 0.0
            f1 = (2 * precision * recall / (precision + recall)
                  if precision + recall else 0.0)
            return precision, recall, f1

        precision, recall, f1 = _prf(tp, fp, fn)
        m_precision, m_recall, m_f1 = _prf(mtp, mfp, mfn)
        test_metrics = {
            "test_loss": float(np.mean(te_losses)) if te_losses else 0.0,
            "tau_rmse": float(np.mean(tau_es)) if tau_es else 0.0,
            "f_rmse": float(np.mean(f_es)) if f_es else 0.0,
            # reference-parity count-based protocol (train.py:381-426)
            "precision": precision,
            "recall": recall,
            "f1_score": f1,
            # position-matched protocol (peaks/metrics.py semantics): a
            # prediction counts only within MATCH_TOL of an unmatched true
            # target -- co-reported so a collapsed head cannot self-certify
            # via the degenerate count metric (round-3 verdict, weak-7)
            "matched_precision": m_precision,
            "matched_recall": m_recall,
            "matched_f1": m_f1,
            # None (not NaN) when nothing matched, so the JSON stays strict
            "matched_tau_rmse": (
                float(np.sqrt(m_tau_sse / mtp)) if mtp else None
            ),
            "matched_f_rmse": (
                float(np.sqrt(m_f_sse / mtp)) if mtp else None
            ),
            "match_tol": MATCH_TOL,
        }
        metrics.write_test_result(test_metrics)
        metrics.log("test", **test_metrics)

    return TrainResult(
        params=params,
        history=history,
        best_val_loss=best_val,
        test_metrics=test_metrics,
        epochs_run=epochs_run,
    )
