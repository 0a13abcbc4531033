"""The train steps of the three methods (s2r_tpu/train/steps.py), and the
eval step.

``make_output_adapt_step`` (steps.py:49-165), the output-space adaptation
step:
One call is one iteration of the reference's train_adapt.py:126-181: G
(DeepLab) forwards the source and then the target batch in train mode (the
BatchNorm running statistics update in that order); G is trained on the
source CE plus BCE(D(softmax(tgt)), source label) with D held constant,
and D on BCE(D(softmax(detached src)), 0) + BCE(D(softmax(detached tgt)),
1).  The adversarial softmax runs over the batch axis by default, the
reference's F.softmax(output, dim=0).  G steps with SGD under 1x
(backbone) / 10x (ASPP, decoder) learning rates, D with Adam; one
scheduler's rate drives both (train_adapt.py:133 overrides Adam's).

The JAX package partitions the gradients with stop_gradient on one joint
loss and shares D's target forward between two terms.  Here D's parameters
stop requiring gradients for the adversarial forward and the D terms see
detached maps, as in the reference, so one torch.autograd.grad over the
summed losses yields exactly G's and D's gradients; D runs three forwards,
so its first conv's kernel launches three times a step.  No value is read
back to the host inside the step.

``make_feature_adapt_step`` (steps.py:172-297) is one iteration of the
reference's train.py:181-211, the feature-space adaptation step: G
forwards the source batch, the domain classifier D its ASPP feature, then
G the target batch and D its feature, all in train mode and in that
order.  One gradient of task + d + d_inv over G and D; then the task
optimizer steps all of G, the d optimizer D, and the d_inv optimizer f =
backbone + ASPP again with the same f-gradient (its own buffers; weight
decay on the task-updated f).  No learning-rate groups.  With
`source_only` (train.py --dataset gtav) only the task loss and the task
optimizer run; D is not touched.

``make_eval_step`` is the validation step (s2r_tpu/train/steps.py:300): an
eval-mode forward of G, the seg loss on its float32 logits, the argmax and
the confusion matrix, all on G's device.

Data parallel (`mesh`, core/mesh.py, of more than one process; one
process per device, each stepping its share of the global batch): the
losses are this rank's shares of the global means (train/losses.py), the
BatchNorm statistics global (models/layers.py ``set_batchnorm_sync``),
and the batch-axis softmax is taken over the global batch
(``batch_softmax``).  After the one ``torch.autograd.grad`` of a step the
gradients are summed over the ranks in one flat buffer, then the fused
optimizers apply them on every rank, so every rank holds the same state
after every step; the logged losses are summed over the ranks in one
more.  No DDP: the steps run G twice and D three times before their one
gradient, and DDP would also re-broadcast the BatchNorm buffers from rank
0 on every forward (here they come out equal on every rank).  Each rank
draws its dropout masks from its own generator (train/setup.py).  At one
process nothing of this runs.

Spatial sharding (`layout`, core/mesh.py Layout with spatial S > 1;
s2r_tpu/core/mesh.py:26-69): each rank steps a band of its data row's
samples' rows, by the band rule at the path's largest stride
(``path_stride``: ASPP's output stride, and 32 where the discriminator
reads the maps), so any height runs on any S and the last band or bands
are short or empty.  The batch carries the global height ('height', as
core/mesh.py ``Layout.band`` gives it).  The forwards (G's, D's or the domain
classifier's) run inside ops/halo.py's ``row_shard`` over the 'space'
group; the batch-axis softmax reduces over the 'data' group, the ranks
holding the same rows of other samples; the losses, BatchNorm, the
gradients and the metrics stay over the world, each normalizer a count
of real elements over it.  The eval step runs under ``row_shard`` over
its `rows` mesh (the 'space' group, or the world under
``--eval-spatial-shard``).

Masked batch padding (`pad_to`, s2r_tpu/train/steps.py:86-130,
:205-245): with pad_to = N > k, the batch of k samples is zero-padded to
N (labels with 255, which the seg loss ignores) and the padding samples
are masked out of every quantity across samples: BatchNorm's statistics
and running update and Dropout's draw (models/layers.py
``bn_real_batch``), the batch-axis softmax (taken over the real rows and
padded back with zeros) and D's and the domain classifier's means (over
the real rows).  The step then computes what the unpadded step computes.
The JAX package pads on a TPU only (train/setup.py ``_step_pad_to``), so
no driver pads here; a caller of the step factories may.  Under a mesh,
`pad_to` is the global padded batch and each of the D ranks of the
'data' group pads its real samples (a prefix of its shard, possibly
none) to pad_to / D; the JAX layout puts the pad samples at the end of
the global batch, on the last rank or ranks.  One all-gather of the
ranks' real counts (read on the host) gives BatchNorm the real samples
over the group; the batch-axis softmax and the losses leave the pad
samples out over their groups.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
import torch.nn as nn

from s2r_tpu_torch.core.mesh import Layout, Mesh, make_layout
from s2r_tpu_torch.eval.metrics import confusion_matrix
from s2r_tpu_torch.io.convert import (deeplab_param_order,
                                      discriminator_param_order,
                                      domain_param_order,
                                      feature_param_order)
from s2r_tpu_torch.models.layers import bn_real_batch
from s2r_tpu_torch.ops import halo
from s2r_tpu_torch.train.losses import (bce_with_logits, domain_loss,
                                        real_count)
from s2r_tpu_torch.train.optim import FusedOptimizer
from s2r_tpu_torch.train.state import TrainState

SOURCE_LABEL = 0.0  # train_adapt.py:117
TARGET_LABEL = 1.0  # train_adapt.py:118
D_STRIDE = 32  # the discriminator's five stride-2 convs


def path_stride(deeplab, method: str) -> int:
    """The largest stride of a method's path, the band rule's unit: ASPP's,
    and D's where the discriminator reads the full-resolution maps."""
    if method == "output_adapt":
        return max(deeplab.row_stride, D_STRIDE)
    return deeplab.row_stride


class _BatchSoftmax(torch.autograd.Function):
    """Softmax over dim 0 of every rank's batch: the maximum and the sum of
    exp over the batch all-reduced, and in the backward the sum of g * y;
    the math in float32 (float64 stays float64), the result in x's type."""

    @staticmethod
    def forward(ctx, x, mesh):
        f = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(f)
        top = (xf.amax(0) if x.shape[0]  # a rank of padding has none
               else xf.new_full(x.shape[1:], float("-inf")))
        top = mesh.all_reduce_(top.contiguous(), op="max")
        e = torch.exp(xf - top)
        y = e / mesh.all_reduce_(e.sum(0))
        ctx.save_for_backward(y)
        ctx.mesh = mesh
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, gy):
        (y,) = ctx.saved_tensors
        g = gy.to(y.dtype)
        dot = ctx.mesh.all_reduce_((g * y).sum(0))
        return (y * (g - dot)).to(gy.dtype), None


def batch_softmax(logits: torch.Tensor, mesh=None) -> torch.Tensor:
    """Softmax over the batch axis of NCHW logits, the global batch's under
    `mesh` (the JAX package's softmax over a sharded batch axis)."""
    if mesh is None or mesh.size == 1:
        return torch.softmax(logits, dim=0)
    return _BatchSoftmax.apply(logits, mesh)


def _adv_softmax(logits: torch.Tensor, mode: str, mesh=None) -> torch.Tensor:
    """NCHW logits -> the map D sees: softmax over the batch axis
    ('batch', the reference's dim=0; the global batch under `mesh`) or
    over the classes ('class')."""
    if mode == "batch":
        return batch_softmax(logits, mesh)
    return torch.softmax(logits, dim=1)


def _reduce_metrics(metrics: Dict, mesh) -> Dict:
    """Loss shares -> the global values, summed over the ranks in float64
    (one all-reduce); 'lr' is the same on every rank and passes."""
    if mesh.size == 1:
        return metrics
    keys = [k for k in metrics if k != "lr"]
    summed = mesh.all_reduce_(torch.stack([metrics[k].double()
                                           for k in keys]))
    return {**metrics, **{k: v.to(metrics[k].dtype)
                          for k, v in zip(keys, summed)}}


def _ordered(module: nn.Module, names: List[str]) -> List[nn.Parameter]:
    params = dict(module.named_parameters())
    if sorted(params) != sorted(names):
        raise ValueError(f"{type(module).__name__}: parameters "
                         f"{sorted(set(params) ^ set(names))} do not match "
                         "the JAX package's layout")
    return [params[k] for k in names]


def segmenter_params(deeplab) -> Tuple[List[nn.Parameter], List[float]]:
    """DeepLab's parameters in the JAX flatten order, and their learning-
    rate multipliers: 1 for the backbone, 10 for ASPP and decoder
    (deeplab.py:42-72)."""
    names = deeplab_param_order(deeplab.backbone_name)
    return (_ordered(deeplab, names),
            [1.0 if k.startswith("backbone.") else 10.0 for k in names])


def discriminator_params(discriminator) -> List[nn.Parameter]:
    """The discriminator's parameters in the JAX flatten order."""
    return _ordered(discriminator, discriminator_param_order())


def domain_params(domain_cls) -> List[nn.Parameter]:
    """The domain classifier's parameters in the JAX flatten order."""
    return _ordered(domain_cls, domain_param_order())


def feature_params(deeplab) -> List[nn.Parameter]:
    """f = backbone + ASPP of DeepLab, in the JAX flatten order."""
    params = dict(deeplab.named_parameters())
    return [params[k] for k in feature_param_order(deeplab.backbone_name)]


def _layout(mesh, layout) -> Layout:
    """The step's layout: `layout`, or `mesh` (None: one process) without
    a spatial axis."""
    if layout is not None:
        return layout
    return make_layout(mesh or Mesh())


def _rows(layout: Layout, x: torch.Tensor, stride: int, height=None):
    """The row sharding of a forward over NCHW x, a band of its samples'
    rows of the global `height` under a spatial layout (nothing without
    one)."""
    return halo.row_shard(layout.space, height, stride, layout.data,
                          x.shape[3])


class _Padding:
    """The batch padding of one step on this rank: `k` real samples of `n`
    (k None: none of this rank's samples is padding, and pad and real are
    the identity), and `total`, the real samples over the 'data' group
    `data` (None: no padding).  `pad_to` is the global padded batch."""

    def __init__(self, pad_to, n_in: int, data, device):
        self.k, self.n, self.total = None, n_in, None
        if pad_to is None:
            return
        if pad_to % data.size:
            raise ValueError(f"pad_to {pad_to} does not split over the "
                             f"{data.size} ranks of the 'data' group")
        self.n = pad_to // data.size
        if n_in > self.n:
            raise ValueError(f"pad_to: {n_in} samples on a rank of "
                             f"{self.n} (pad_to {pad_to} / {data.size})")
        self.total = n_in
        if data.size > 1:
            counts = data.all_gather(torch.tensor(
                [n_in], dtype=torch.int64, device=device))
            self.total = int(sum(int(c.sum()) for c in counts))
        if n_in < self.n:
            self.k = n_in

    def pad(self, x: torch.Tensor, fill=0) -> torch.Tensor:
        """x [k, ...] -> [n, ...], the new samples `fill`."""
        if self.k is None:
            return x
        return torch.cat([x, x.new_full((self.n - self.k,)
                                        + tuple(x.shape[1:]), fill)])

    def real(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.k is None else x[:self.k]


def make_output_adapt_step(deeplab, discriminator, g_opt, d_opt,
                           lr_fn: Callable, seg_loss_fn: Callable,
                           adv_softmax_mode: str = "batch",
                           pad_to: int = None, mesh=None, layout=None):
    """step(state, batch) -> (state, metrics) over `deeplab` (G) and
    `discriminator` (D), the modules `state` holds.

    batch: 'src_image', 'tgt_image' NHWC float, 'src_label' [N,H,W] int
    (tensors or arrays; moved to G's device).  metrics: 'seg_loss',
    'adv_loss', 'd_loss' and 'lr' as device tensors.  The modules are left
    in train mode.  `pad_to`: masked batch padding (module docstring).
    `mesh`: data parallel (module docstring); `seg_loss_fn` must then be
    built over the same mesh.  `layout` (core/mesh.py Layout; its world
    replaces `mesh`): spatial sharding (module docstring).
    """
    layout = _layout(mesh, layout)
    mesh = layout.world
    stride = path_stride(deeplab, "output_adapt")
    if adv_softmax_mode not in ("batch", "class"):
        raise ValueError(f"adv_softmax_mode {adv_softmax_mode!r}")
    g_params, g_mult = segmenter_params(deeplab)
    d_params = discriminator_params(discriminator)
    fused_g = FusedOptimizer(g_opt, g_params, g_mult)
    fused_d = FusedOptimizer(d_opt, d_params)
    n_g = len(g_params)

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        dev = deeplab.device
        lr = float(lr_fn(state.step))
        src = torch.as_tensor(batch["src_image"], device=dev)
        padding = _Padding(pad_to, src.shape[0], layout.data, dev)
        pad, real = padding.pad, padding.real
        src = pad(src).permute(0, 3, 1, 2)
        tgt = pad(torch.as_tensor(batch["tgt_image"],
                                  device=dev)).permute(0, 3, 1, 2)
        label = pad(torch.as_tensor(batch["src_label"], device=dev), 255)
        deeplab.train()
        discriminator.train()
        with _rows(layout, src, stride, batch.get("height")):
            with bn_real_batch(padding.k, padding.total):
                src_logits, _ = deeplab(src, generator=state.generator)
                tgt_logits, _ = deeplab(tgt, generator=state.generator)
            l_seg = seg_loss_fn(src_logits, label)
            tp = pad(_adv_softmax(real(tgt_logits), adv_softmax_mode,
                                  layout.data))
            sp = pad(_adv_softmax(real(src_logits.detach()),
                                  adv_softmax_mode, layout.data))
            # G's adversarial term: D constant (train_adapt.py:140-155)
            for p in d_params:
                p.requires_grad_(False)
            try:
                d_adv = real(discriminator(tp))
            finally:
                for p in d_params:
                    p.requires_grad_(True)
            n_d = real_count(d_adv, mesh)  # D's real outputs, every rank's
            l_adv = bce_with_logits(d_adv, SOURCE_LABEL, mesh, n_d)
            # D's terms on detached maps (train_adapt.py:157-178)
            l_d = (bce_with_logits(real(discriminator(sp)), SOURCE_LABEL,
                                   mesh, n_d)
                   + bce_with_logits(real(discriminator(tp.detach())),
                                     TARGET_LABEL, mesh, n_d))
        grads = mesh.all_reduce_flat(torch.autograd.grad(
            l_seg + l_adv + l_d, g_params + d_params))
        state.opt_state = {
            "G": fused_g.apply(grads[:n_g], state.opt_state["G"], g_params, lr),
            "D": fused_d.apply(grads[n_g:], state.opt_state["D"], d_params, lr)}
        state.step += 1
        metrics = {"seg_loss": l_seg.detach(), "adv_loss": l_adv.detach(),
                   "d_loss": l_d.detach(),
                   "lr": torch.tensor(lr, dtype=torch.float32, device=dev)}
        return state, _reduce_metrics(metrics, mesh)

    return step


def make_feature_adapt_step(deeplab, domain_cls, task_opt, d_opt, d_inv_opt,
                            lr_fn: Callable, seg_loss_fn: Callable,
                            source_only: bool = False, pad_to: int = None,
                            mesh=None, layout=None):
    """step(state, batch) -> (state, metrics) over `deeplab` (G) and
    `domain_cls` (D), the modules `state` holds.

    batch: 'src_image', 'tgt_image' NHWC float and 'src_label' [N,H,W]
    int; with `source_only`, 'image' and 'label' (tensors or arrays; moved
    to G's device).  metrics: 'task_loss', 'd_loss', 'd_inv_loss', 'd_acc'
    and 'lr' as device tensors (the middle three zeros with
    `source_only`).  state.opt_state is {'task', 'd', 'd_inv', 'c'};
    'c' is carried and never stepped (train.py:202-204).  The modules are
    left in train mode.  `pad_to`: masked batch padding, `mesh`: data
    parallel, `layout`: spatial sharding (module docstring).
    """
    layout = _layout(mesh, layout)
    mesh = layout.world
    stride = path_stride(deeplab, "feature_adapt")
    g_params, _ = segmenter_params(deeplab)  # no 1x/10x groups here
    d_params = domain_params(domain_cls)
    f_params = feature_params(deeplab)
    fused_task = FusedOptimizer(task_opt, g_params)
    fused_d = FusedOptimizer(d_opt, d_params)
    fused_inv = FusedOptimizer(d_inv_opt, f_params)
    f_index = {id(p): i for i, p in enumerate(g_params)}
    f_at = [f_index[id(p)] for p in f_params]
    n_g = len(g_params)
    src_key, lbl_key = (("image", "label") if source_only
                        else ("src_image", "src_label"))

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        dev = deeplab.device
        lr = float(lr_fn(state.step))
        src = torch.as_tensor(batch[src_key], device=dev)
        padding = _Padding(pad_to, src.shape[0], layout.data, dev)
        pad, real = padding.pad, padding.real
        src = pad(src).permute(0, 3, 1, 2)
        label = pad(torch.as_tensor(batch[lbl_key], device=dev), 255)
        gen = state.generator
        deeplab.train()
        rows = _rows(layout, src, stride, batch.get("height"))
        real_batch = bn_real_batch(padding.k, padding.total)
        with rows, real_batch:
            src_out, src_feat = deeplab(src, generator=gen)
        task = seg_loss_fn(src_out, label)
        opt = dict(state.opt_state)
        if source_only:
            grads = mesh.all_reduce_flat(torch.autograd.grad(task, g_params))
            opt["task"] = fused_task.apply(grads, opt["task"], g_params, lr)
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            d_l = d_inv_l = d_acc = zero
        else:
            tgt = pad(torch.as_tensor(batch["tgt_image"],
                                      device=dev)).permute(0, 3, 1, 2)
            domain_cls.train()
            with rows, real_batch:
                src_d = domain_cls(src_feat, generator=gen)
                _, tgt_feat = deeplab(tgt, generator=gen)
                tgt_d = domain_cls(tgt_feat, generator=gen)
            src_d, tgt_d = real(src_d), real(tgt_d)
            n_d = real_count(src_d[:, 0], mesh)
            d_l, d_acc = domain_loss(src_d, tgt_d, mesh, n_d)
            d_inv_l, _ = domain_loss(tgt_d, src_d, mesh, n_d)
            grads = mesh.all_reduce_flat(torch.autograd.grad(
                task + d_l + d_inv_l, g_params + d_params))
            # train.py:202-204, in torch's order: task over G, d over D,
            # then d_inv over the task-updated f with the same gradient
            opt["task"] = fused_task.apply(grads[:n_g], opt["task"],
                                           g_params, lr)
            opt["d"] = fused_d.apply(grads[n_g:], opt["d"], d_params, lr)
            opt["d_inv"] = fused_inv.apply([grads[i] for i in f_at],
                                           opt["d_inv"], f_params, lr)
        state.opt_state = opt
        state.step += 1
        metrics = {"task_loss": task.detach(), "d_loss": d_l.detach(),
                   "d_inv_loss": d_inv_l.detach(), "d_acc": d_acc.detach(),
                   "lr": torch.tensor(lr, dtype=torch.float32, device=dev)}
        return state, _reduce_metrics(metrics, mesh)

    return step


def make_eval_step(deeplab, seg_loss_fn: Callable, num_classes: int,
                   rows=None, unit: int = None):
    """eval_step(image, label, height=None) -> (loss, cm, pred) on
    `deeplab`.

    image NHWC float, label [N,H,W] int (tensors or arrays; moved to G's
    device).  The forward runs in eval mode (running-statistics BatchNorm,
    no dropout) and the module's mode is restored after it.  loss is a
    float32 scalar, cm the [C, C] int64 confusion matrix and pred the
    [N,H,W] argmax, all on the device: nothing is read back to the host.
    `rows` (a mesh of more than one process): image and label are this
    rank's band of the batch's rows of global `height`, by the band rule
    at `unit` (None: the model's row stride), the forward runs
    row-sharded over it, and
    loss and cm are this rank's shares (the seg loss over the world).
    """
    unit = deeplab.row_stride if unit is None else int(unit)

    @torch.no_grad()
    def eval_step(image, label, height=None):
        dev = deeplab.device
        x = torch.as_tensor(image, device=dev).permute(0, 3, 1, 2)
        label = torch.as_tensor(label, device=dev)
        was_training = deeplab.training
        deeplab.eval()
        try:
            with halo.row_shard(rows, height, unit, width=x.shape[3]):
                logits, _ = deeplab(x)
        finally:
            deeplab.train(was_training)
        loss = seg_loss_fn(logits, label)
        pred = logits.argmax(1)
        return loss, confusion_matrix(label, pred, num_classes), pred

    return eval_step
