"""Command line: ``python -m exoground_tpu_torch.train.main --dataset ...
--model ... --data_root <tree>``.

Counterpart of ``exoground_tpu/train/main.py`` (``main`` :179, ``build_model``
:119, ``build_egoexo_dataset`` :28, ``build_lemma_dataset`` :81,
``load_frozen_vi_encoder`` :156, ``run_htm_e2e`` :247-338, ``run_htm_tan``
:344-469) for three routes:

  * ``--dataset egoexo4d | lemma`` with ``--model view_invariant |
    grounding | joint``: keystep grounding and its view-invariant
    distillation (``EgoExoTrainer``), the repo's ``scripts/train_vi.sh``,
    ``train_grounding.sh`` (the frozen VI encoder from
    ``--vi_encoder_path``), ``train_joint_model.sh`` (with the curriculum)
    and ``train_joint_model_lemma.sh``, and their ``scripts/test_*.sh``:
    ``--test`` prints and returns the results (the IoU by camera rank for
    grounding / joint) and writes ``test_results_epoch_0.json``;
  * ``--dataset htm-*`` with ``--model init | cotrain``: TAN on HowTo100M
    features, with the frozen word2vec tower inside the step, a validation
    loss and the in-loop HTM-Align eval every ``--eval_freq`` epochs;
  * ``--dataset htm-aa --model s3d``: the end-to-end S3D-G finetune on
    HTM-AA clips (``S3DTrainer``), the repo's ``scripts/train_e2e.sh``
    (``--freezeBN``, 16 frames at 5 fps, 224² crops), the MIL-NCE trunk
    from ``s3d_howto100m.pth`` unless ``--no-pt_backbone``, ``--lr_backbone``
    its second LR; it prints how many clips ffmpeg decoded and how many
    came out grey (``clips {...}``).

Both checkpoint every epoch; ``--resume``, ``--pretrain`` and ``--test``
load them back, or load the JAX package's checkpoints (flax msgpack files,
told apart by their first bytes, and orbax directories: no flag), so a
run trained with the JAX package continues here. The optimizer is the JAX command line's: fused
AdamW, or the optax chain under ``--no-fused_optimizer`` or
``--backprop_freq k``; ``--fused_steps N`` replays N steps as one CUDA graph
and ``--amp`` computes in bfloat16 with float32 masters.

The command line always takes the card (``main`` raises without one);
``main(argv, device="cpu")`` runs the plain path on the CPU, as the tests
do. A model on a dataset of the other family raises ``ValueError``.

Data parallel, one process a card (``parallel/mesh.py``; the JAX command
line's ``--dp_devices`` / ``--multihost``, main.py:186-201):
  * under a ``torch.distributed.run`` launch (RANK, WORLD_SIZE, LOCAL_RANK,
    LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT set) each process joins the
    launch's group: NCCL on ``cuda:<LOCAL_RANK>``, gloo on the CPU, no
    fallback between them. ``--multihost`` asks for that group and raises
    without its environment;
  * otherwise ``--dp_devices N`` > 1 spawns N ranks on this host over
    ``tcp://localhost``; 0 means every card (1 on the CPU).
The samplers shard by host, each rank takes its block of the host's batch
(``--batch_size`` must divide by the host's ranks), and only rank 0
writes. The chief prints a ``run_summary`` line at the end: the world and
backend, the steps and their losses, the collectives and kernel launches
of its process.

Expected --data_root layouts (as the JAX routes'):
  EgoExo4D: splits/{split}.csv, keystep_annotations/{split}.csv (or
    narration_annotations/ without --use_keysteps), all_camera_rankings.json,
    takes.json, egovlpv2_video_features/{take}_{cam}.pt,
    narration_features/{take}/{nid}.pt [, audio_features/, camera_pose/]
  LEMMA: splits/{split}.csv (video_id,duration_sec),
    keystep_annotations/{split}.csv + all.csv (hoi_index,natural_language),
    vid_feats/{video_id}_{cam}.pt, keystep_feats/{hoi}.pt
  HowTo100M:
    howto100m_s3d_features/*.mp4.npy         per-second video features
    sentencified_htm_<tag>.json              ASR sentences ({vid: {...}})
    htm_holdout_vid.txt, htm_vlen.csv        filters (optional)
    s3d_dict.npy + s3d_howto100m.pth         word2vec tokenizer + tower
    htm_align.json (optional)                in-loop HTM-Align eval
  HTM-AA (tools/synth_htm_aa.py writes one):
    {auto_align_tag}.csv                     vid,timestamp,text alignment rows
    htm_vlen.csv (optional)                  vid,vlen: keeps 64 < vlen < 2000
    videos/{vid}.mp4                         raw videos (ffmpeg decode; grey
                                             frames where it fails)
    s3d_dict.npy + s3d_howto100m.pth         tokenizer + the MIL-NCE weights
"""

from __future__ import annotations

import json
import os
import sys
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.distributed as dist

_TAN_MODELS = ("init", "cotrain")
_GROUNDING_MODELS = ("view_invariant", "grounding", "joint")
_GROUNDING_DATASETS = ("egoexo4d", "lemma")


def _check_model(cfg) -> None:
    """The model must be one of its dataset's family (the JAX route would
    hand it to the other family's trainer, which cannot train it)."""
    if cfg.dataset == "htm-aa" or cfg.model == "s3d":
        cfg.validate()  # s3d trains on htm-aa alone, and htm-aa trains s3d
        return
    family = _GROUNDING_MODELS if cfg.dataset in _GROUNDING_DATASETS else _TAN_MODELS
    if cfg.model not in family:
        raise ValueError(f"--model {cfg.model} does not train on --dataset {cfg.dataset}: "
                         f"its models are {', '.join(family)}")


def build_model(cfg, video_dim: Optional[int] = None, text_dim: Optional[int] = None,
                device="cuda"):
    """The model of ``cfg``, as the JAX ``build_model`` builds it: for init /
    cotrain ``TemporalAligner``, its pre-projections sized by the data's
    video and text widths (the JAX Dense layers take them from the input);
    for view_invariant ``ViewInvariantMLP``, for grounding ``GroundingModel``
    with the MLP VI pre-pass, for joint ``ExoGroundingTransformer``, at the
    configuration's feature widths."""
    from exoground_tpu_torch.models import TemporalAligner
    from exoground_tpu_torch.models.grounding import ExoGroundingTransformer, GroundingModel
    from exoground_tpu_torch.models.vi_encoder import ViewInvariantMLP

    _check_model(cfg)
    attn = None if cfg.attn_impl == "auto" else cfg.attn_impl
    if cfg.model in _TAN_MODELS:
        return TemporalAligner(
            num_encoder_layers=cfg.num_encoder_layers,
            num_joint_layers=cfg.num_decoder_layers,
            pos_enc=cfg.pos_enc, use_text_pos_enc=int(cfg.use_text_pos_enc),
            use_alignability_head=int(cfg.use_alignability_head), attn_impl=attn,
            video_dim=video_dim, text_dim=text_dim, device=device)
    if cfg.model == "view_invariant":
        return ViewInvariantMLP(video_embed_dim=cfg.video_feature_dim, device=device)
    multi = cfg.views == "multi"
    common = dict(
        num_encoder_layers=cfg.num_encoder_layers, num_decoder_layers=cfg.num_decoder_layers,
        use_decoder=cfg.use_decoder, pos_enc=cfg.pos_enc,
        use_text_pos_enc=int(cfg.use_text_pos_enc), use_audio=cfg.use_audio,
        video_embed_dim=cfg.video_feature_dim, text_embed_dim=cfg.text_feature_dim,
        audio_embed_dim=cfg.audio_feature_dim, feature_dim=cfg.feature_dim,
        use_distill_nce_loss=cfg.use_distill_nce_loss, multi_view=multi,
        num_max_views=cfg.num_max_views if multi else 1,
        use_pairwise_distill_nce_loss=cfg.use_pairwise_distill_nce_loss,
        pairwise_distill_mode=cfg.pairwise_distill_mode, attn_impl=attn, device=device)
    if cfg.model == "grounding":
        return GroundingModel(vi_encoder_type="mlp", **common)
    return ExoGroundingTransformer(**common)


def main(argv=None, device="cuda"):
    """Parse ``argv`` and run its route on ``device``: in the process group
    of a ``torch.distributed.run`` launch, over ``--dp_devices`` spawned
    ranks, or in this process alone. Returns what the route returns on rank
    0 (the best score, or the ``--test`` results)."""
    from exoground_tpu_torch.parallel.mesh import LAUNCH_ENV
    from exoground_tpu_torch.train.config import parse_args
    from exoground_tpu_torch.utils.device import resolve_device

    argv = sys.argv[1:] if argv is None else list(argv)
    cfg = parse_args(argv)
    dev = resolve_device(device)
    if cfg.dataset not in _GROUNDING_DATASETS and not cfg.dataset.startswith("htm"):
        raise SystemExit(f"unknown --dataset {cfg.dataset}")
    _check_model(cfg)  # before set_path writes the experiment directory
    launched = all(k in os.environ for k in LAUNCH_ENV)
    if cfg.multihost and not launched:
        missing = [k for k in LAUNCH_ENV if k not in os.environ]
        raise RuntimeError(
            f"--multihost joins the process group of a torch.distributed.run launch, but "
            f"{', '.join(missing)} {'is' if len(missing) == 1 else 'are'} not set: launch "
            "with python -m torch.distributed.run --nnodes ... --nproc_per_node ... -m "
            "exoground_tpu_torch.train.main ...")
    if launched:
        return _run_in_group(cfg, dev)
    n = _dp_ranks(cfg, dev)
    if n > 1:
        if cfg.batch_size % n:
            raise ValueError(f"--batch_size {cfg.batch_size} does not split over "
                             f"--dp_devices {n}")
        return _spawn(argv, str(device), n)
    return _run(cfg, dev, None)


def _dp_ranks(cfg, device: torch.device) -> int:
    """The ranks ``--dp_devices`` asks for on this host: 0 is every card
    (1 on the CPU); more than the cards present raises."""
    cards = torch.cuda.device_count() if device.type == "cuda" else None
    n = cfg.dp_devices or (cards or 1)
    if cards is not None and n > cards:
        raise ValueError(f"--dp_devices {n}: this host has {cards} cards")
    return n


def _run(cfg, device, mesh):
    """The route of ``cfg`` on ``device`` in ``mesh`` (None: no group)."""
    from exoground_tpu_torch.parallel import collectives
    from exoground_tpu_torch.train.config import set_path

    chief = mesh is None or mesh.rank == 0
    timestamp = "" if mesh is None else collectives.broadcast_object(
        _timestamp(), mesh)  # one experiment directory for every rank
    set_path(cfg, timestamp=timestamp, write=chief)
    if cfg.dataset in _GROUNDING_DATASETS:
        return run_egoexo(cfg, device, mesh)
    if cfg.dataset == "htm-aa":
        return run_htm_e2e(cfg, device, mesh)
    return run_htm_tan(cfg, device, mesh)


def _timestamp() -> str:
    from datetime import datetime

    return datetime.now().strftime("%Y_%m_%d_%H_%M")


def _run_in_group(cfg, device):
    """Join the launch's process group (NCCL on this rank's card, gloo on
    the CPU), run the route in it and leave the group."""
    from exoground_tpu_torch.parallel.mesh import make_mesh

    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
        # device_id: the communicator is made now, before any graph capture
        dist.init_process_group("nccl", device_id=device)
    else:
        dist.init_process_group("gloo")
    try:
        mesh = make_mesh(device=device)
        if cfg.batch_size % mesh.local_world:
            raise ValueError(f"--batch_size {cfg.batch_size} does not split over the "
                             f"{mesh.local_world} ranks of a host")
        return _run(cfg, device, mesh)
    finally:
        dist.destroy_process_group()


def _spawn(argv, device: str, n: int):
    """``n`` ranks of this command line on this host, each in a process of
    its own under a launch environment over ``tcp://localhost``; returns
    rank 0's result."""
    import torch.multiprocessing as mp

    from exoground_tpu_torch.parallel.mesh import free_port

    # the ranks keep this process's blocked imports (modules set to None)
    blocked = [k for k, v in sys.modules.items() if v is None]
    results = mp.get_context("spawn").SimpleQueue()
    mp.start_processes(_rank_main, nprocs=n, start_method="spawn",
                       args=(n, free_port(), argv, device, torch.get_num_threads(), blocked,
                             results))
    return results.get()


def _rank_main(rank, world, port, argv, device, threads, blocked, results):
    from exoground_tpu_torch.parallel.mesh import launch_env

    os.environ.update(launch_env(rank, world, port))
    sys.modules.update(dict.fromkeys(blocked))
    torch.set_num_threads(max(1, threads // world))  # the host's cores, shared
    out = main(argv, device)
    if rank == 0:
        results.put(out)


def _summary(trainer) -> None:
    """The chief's ``run_summary`` line: the group, the steps and their
    losses (full precision), the epochs' timing summary, the collectives
    and kernel launches of this process."""
    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.parallel import collectives
    from exoground_tpu_torch.train.trainer import epoch_summary

    if not trainer.is_chief:
        return
    stats = [s for s in trainer.epoch_stats if s["steps"]]
    timing = epoch_summary(stats) if stats else {}
    print("run_summary " + json.dumps(dict(
        world=trainer.mesh.world, backend=trainer.mesh.backend,
        steps=sum(s["steps"] for s in stats), losses=[l for s in stats for l in s["losses"]],
        step_ms=[t * 1e3 for s in stats for t in s["step_s"]], timing=timing,
        collectives=dict(collectives.COLLECTIVES),
        launches={k: v for k, v in _kernels.LAUNCHES.items() if v},
        captures=getattr(getattr(trainer, "fused_step", None), "captures", 0))), flush=True)


@dataclass
class TrainRun:
    """What ``build_htm_tan`` or ``build_egoexo`` builds from a
    configuration (``dataset``: the training reader, for its curriculum)."""

    trainer: object
    train_loader: object
    val_loader: object = None
    downstream: Optional[Callable] = None
    dataset: object = None

    def close(self):
        self.trainer.close()
        self.train_loader.close()
        if self.val_loader is not None:
            self.val_loader.close()


# ------------------------------------------------------------ EgoExo4D / LEMMA
def build_egoexo_dataset(cfg, split: str):
    """The EgoExo4D reader of ``split`` over ``--data_root``, its windows
    cached in ``{model}_{split}_{views}_ks=.._ct=.._exos=.._windows.csv``
    beside the data, the JAX cache's name (main.py:28-78). The curriculum
    is the training split's alone (the reader asserts it): the JAX route
    hands ``--curriculum_train`` to the val and test readers too, whose
    assertion then stops ``scripts/train_joint_model.sh`` before it trains."""
    from exoground_tpu_torch.data.egoexo4d import EgoExo4DDataset, EgoExoConfig, EgoExoSource

    root = cfg.data_root
    curriculum = cfg.curriculum_train and split == "train"
    src = EgoExoSource.from_paths(
        split_csv=os.path.join(root, "splits", f"{split}.csv"),
        annotations_csv=os.path.join(
            root, "keystep_annotations" if cfg.use_keysteps else "narration_annotations",
            f"{split}.csv"),
        camera_rankings_json=os.path.join(root, "all_camera_rankings.json"),
        takes_json=os.path.join(root, "takes.json"),
        video_feature_root=os.path.join(root, "egovlpv2_video_features"),
        narration_feature_root=os.path.join(root, "narration_features"),
        audio_feature_root=(os.path.join(root, "audio_features", split)
                            if cfg.use_audio else None),
        camera_pose_root=(os.path.join(root, "camera_pose")
                          if os.path.isdir(os.path.join(root, "camera_pose")) else None),
    )
    dcfg = EgoExoConfig(
        duration=cfg.seq_len, hop_length=cfg.seq_hop, use_audio=cfg.use_audio,
        use_keysteps=cfg.use_keysteps, views=cfg.views,
        use_distill_nce_loss=cfg.use_distill_nce_loss,
        use_center_duration=cfg.use_center_duration,
        multi_view_egoexo=cfg.multi_view_egoexo, num_max_views=cfg.num_max_views,
        randomize_narration_order=cfg.randomize_narration_order,
        curriculum_train=curriculum, sorted_curr_train=cfg.sorted_curr_train,
        model=cfg.model, exo_mode=cfg.exos,
        minimum_four_exo_takes=cfg.minimum_four_exo_takes,
        same_view_negative=cfg.same_view_negative, reverse_ranking=cfg.reverse_ranking,
        randomize_ranking=cfg.randomize_ranking, exo_exo_distill=cfg.exo_exo_distill,
        feature_dim=cfg.text_feature_dim, seed=cfg.seed, fps=cfg.fps,
    )
    kind = "grounding" if cfg.model in ("grounding", "joint") else "view_invariant"
    csv_cache = os.path.join(
        root, f"{kind}_{split}_{cfg.views}_ks={cfg.use_keysteps}_ct={curriculum}"
              f"_exos={cfg.exos}_windows.csv")
    return EgoExo4DDataset(dcfg, src, split=split, window_csv_path=csv_cache)


def build_lemma_dataset(cfg, split: str):
    """The LEMMA reader of ``split`` over ``--data_root`` (the JAX
    ``build_lemma_dataset``, main.py:81-116; its CSV files read without
    pandas, typed as pandas types them; the curriculum the training
    split's alone, as for EgoExo4D)."""
    from exoground_tpu_torch.data.io import FeatureStore
    from exoground_tpu_torch.data.lemma import LemmaConfig, LemmaDataset
    from exoground_tpu_torch.data.table import read_csv_records

    root = cfg.data_root
    anno_dir = os.path.join(root, "keystep_annotations")
    hoi = read_csv_records(os.path.join(anno_dir, "all.csv"))
    dcfg = LemmaConfig(
        duration=cfg.seq_len, hop_length=cfg.seq_hop, views=cfg.views,
        use_distill_nce_loss=cfg.use_distill_nce_loss,
        curriculum_train=cfg.curriculum_train and split == "train",
        same_view_negative=cfg.same_view_negative, reverse_ranking=cfg.reverse_ranking,
        randomize_ranking=cfg.randomize_ranking, feature_dim=cfg.text_feature_dim,
        seed=cfg.seed, fps=cfg.fps,
    )
    return LemmaDataset(
        dcfg, read_csv_records(os.path.join(root, "splits", f"{split}.csv")),
        read_csv_records(os.path.join(anno_dir, f"{split}.csv")),
        {r["hoi_index"]: r["natural_language"] for r in hoi},
        video_store=FeatureStore(os.path.join(root, "vid_feats"), (".pt",)),
        narration_store=FeatureStore(os.path.join(root, "keystep_feats"), (".pt",)),
        split=split,
    )


def load_frozen_vi_encoder(trainer, cfg) -> bool:
    """The ``vi_encoder`` branch of a grounding model from a view_invariant
    checkpoint at ``--vi_encoder_path`` (the port's or the JAX package's),
    non-strict, as the JAX ``load_frozen_vi_encoder`` (main.py:156-176);
    nothing when the path is unset or missing. Returns whether it loaded."""
    from exoground_tpu_torch.train.checkpoint import (checkpoint_format, jax_layout, load_state,
                                                      restore_into)
    from exoground_tpu_torch.utils.convert import grounding_state_dict_from_jax

    path = cfg.vi_encoder_path
    if not path or not os.path.exists(path):
        return False
    prefix = "vi_encoder."
    branch = {k[len(prefix):]: v for k, v in trainer.params.items() if k.startswith(prefix)}
    if not branch:
        return False
    blob = load_state(path)
    state = blob["state_dict"]
    if jax_layout(checkpoint_format(path)):
        state = grounding_state_dict_from_jax(state)
    restore_into(branch, state)  # in place: the branch shares the model's storage
    print(f"[main] loaded frozen VI encoder from {path}", flush=True)
    return True


def _hosts(mesh) -> dict:
    """The samplers' sharding: by host (each rank takes its block of the
    host's batch)."""
    return {} if mesh is None else dict(num_shards=mesh.hosts, shard=mesh.host)


def build_egoexo(cfg, device, mesh=None) -> TrainRun:
    """The train and val (or test) readers and loaders of ``--dataset
    egoexo4d | lemma``, the model (seeded by ``cfg.seed``) and the trainer.
    The train sampler is ``CurriculumShardedSampler`` under
    ``--curriculum_train --sorted_curr_train sorted``, else
    ``ShardedSampler``; the eval loader keeps the last partial batch. Both
    shard by host under ``mesh``."""
    from exoground_tpu_torch.data import (
        CurriculumShardedSampler,
        ShardedSampler,
        ThreadedLoader,
    )
    from exoground_tpu_torch.train.trainer import EgoExoTrainer

    build = build_lemma_dataset if cfg.dataset == "lemma" else build_egoexo_dataset
    train_ds = build(cfg, "train")
    val_ds = build(cfg, "test" if cfg.test else "val")
    if cfg.curriculum_train and cfg.sorted_curr_train == "sorted":
        sampler = CurriculumShardedSampler(
            len(train_ds), seed=cfg.seed, max_epochs=cfg.epochs, start_frac=cfg.start_frac,
            end_epoch_frac=cfg.end_epoch_frac, fixed_ramp=cfg.fixed_curriculum,
            **_hosts(mesh))
    else:
        sampler = ShardedSampler(len(train_ds), seed=cfg.seed, **_hosts(mesh))
    train_loader = ThreadedLoader(train_ds, cfg.batch_size, sampler=sampler,
                                  num_workers=cfg.num_workers)
    val_loader = ThreadedLoader(val_ds, cfg.batch_size,
                                sampler=ShardedSampler(len(val_ds), shuffle=False,
                                                       **_hosts(mesh)),
                                num_workers=cfg.num_workers, drop_last=False)
    torch.manual_seed(cfg.seed)  # the model's initial weights
    model = build_model(cfg, device=device)
    trainer = EgoExoTrainer(model, cfg, iters_per_epoch=len(train_loader), device=device,
                            mesh=mesh)
    return TrainRun(trainer, train_loader, val_loader, dataset=train_ds)


def run_egoexo(cfg, device, mesh=None):
    """Grounding-family training (reference main_egoexo4d_distributed.py):
    for grounding the frozen VI encoder first, then ``--resume`` /
    ``--pretrain``; ``--test`` loads a checkpoint, prints ``{'loss': ...,
    results}`` and returns the results; else ``fit`` and its best score."""
    run = build_egoexo(cfg, device, mesh)
    trainer = run.trainer
    try:
        if cfg.model == "grounding" and load_frozen_vi_encoder(trainer, cfg):
            trainer._replicate()
        if cfg.resume:
            trainer.load_checkpoint(cfg.resume, mode="resume")
        elif cfg.pretrain:
            trainer.load_checkpoint(cfg.pretrain, mode="pretrain")
        if cfg.test:
            trainer.load_checkpoint(cfg.test, mode="test")
            loss, results = trainer.evaluate(run.val_loader, epoch=0, test=True)
            if trainer.is_chief:
                print({"loss": loss, **{k: round(v, 4) for k, v in results.items()}},
                      flush=True)
            _summary(trainer)
            return results
        best = trainer.fit(run.train_loader, run.val_loader, dataset=run.dataset)
        _summary(trainer)
        return best
    finally:
        run.close()


# ------------------------------------------------------------------ HowTo100M


def build_htm_tan(cfg, device, mesh=None) -> TrainRun:
    """The tokenizer and frozen tower from ``--data_root``, the train / val
    readers and loaders (sharded by host under ``mesh``), the model (seeded
    by ``cfg.seed``), the trainer and the in-loop HTM-Align eval (when
    ``htm_align.json`` exists: the chief runs it, on its card, and the ranks
    take its result)."""
    from exoground_tpu_torch.data import (
        HTMAlignDataset,
        HTMConfig,
        HTMFeatureDataset,
        ShardedSampler,
        ThreadedLoader,
    )
    from exoground_tpu_torch.models.word2vec import Word2VecModel, Word2VecTokenizer
    from exoground_tpu_torch.train.trainer import TANTrainer
    from exoground_tpu_torch.utils.convert import (
        convert_word2vec_from_s3d,
        load_torch_checkpoint,
    )

    root = cfg.data_root
    tokenizer = Word2VecTokenizer.from_dict_file(os.path.join(root, "s3d_dict.npy"))
    text_tower = Word2VecModel(convert_word2vec_from_s3d(
        load_torch_checkpoint(os.path.join(root, "s3d_howto100m.pth"))), device=device)
    if max(tokenizer.word_to_token.values(), default=0) >= text_tower.vocab_rows:
        raise ValueError(f"s3d_dict.npy holds {len(tokenizer.word_to_token)} words, but the "
                         f"tower embeds only ids below {text_tower.vocab_rows}")

    tag = cfg.dataset.split("-")[-1] if "-" in cfg.dataset else "370k"
    dcfg = HTMConfig(
        video_feature_root=os.path.join(root, "howto100m_s3d_features"),
        asr_json=os.path.join(root, f"sentencified_htm_{tag}.json"),
        holdout_file=os.path.join(root, "htm_holdout_vid.txt"),
        vlen_csv=os.path.join(root, "htm_vlen.csv"),
        duration=cfg.seq_len, seed=cfg.seed,
    )
    # the train batches gather their windows in one native call a batch
    train_ds = HTMFeatureDataset(dcfg, tokenizer, mode="train", defer_video_io=True)
    val_ds = HTMFeatureDataset(dcfg, tokenizer, mode="val", asr=train_ds.asr,
                               store=train_ds.store)
    train_loader = ThreadedLoader(
        train_ds, cfg.batch_size,
        sampler=ShardedSampler(len(train_ds), seed=cfg.seed, **_hosts(mesh)),
        num_workers=cfg.num_workers)
    val_loader = ThreadedLoader(
        val_ds, cfg.batch_size,
        sampler=ShardedSampler(len(val_ds), shuffle=False, **_hosts(mesh)),
        num_workers=cfg.num_workers, drop_last=False)

    video_dim = int(train_ds.store.read(train_ds.video_info[0], 0, 1).shape[-1])
    torch.manual_seed(cfg.seed)  # the model's initial weights
    model = build_model(cfg, video_dim, text_tower.out_dim, device=device)
    trainer = TANTrainer(model, cfg, iters_per_epoch=len(train_loader), device=device,
                         text_tower=text_tower, mesh=mesh)

    downstream = None
    align_json = os.path.join(root, "htm_align.json")
    if os.path.exists(align_json):
        from exoground_tpu_torch.evals import AlignEvalConfig, FusedAlignEvaluator

        with open(align_json) as f:
            align_anno = json.load(f)
        align_ds = HTMAlignDataset(dcfg, tokenizer=tokenizer, mode="full", anno=align_anno,
                                   store=train_ds.store)
        align_items = []
        for i in range(len(align_ds)):
            item = align_ds[i]
            # pad ids masked as in the step's tower, so eval embeddings match
            # the ones the model trains against
            ids = item["token"]
            item["text_embed"] = text_tower(ids, ids != 0)["pooler_output"].cpu().numpy()
            align_items.append(item)
        evaluator_box = {}

        def downstream(tr):
            from exoground_tpu_torch.parallel import collectives

            if not tr.is_chief:
                return collectives.broadcast_object(None, tr.mesh)
            # one evaluator for the run; each eval loads the trainer's
            # current weights into it
            if "ev" not in evaluator_box:
                evaluator_box["ev"] = FusedAlignEvaluator(
                    tr.model, AlignEvalConfig(
                        seq_len=cfg.seq_len,
                        use_alignability_head=bool(cfg.use_alignability_head)),
                    device=tr.device)
            else:
                evaluator_box["ev"].update_params(tr.model.state_dict())
            return collectives.broadcast_object(evaluator_box["ev"](align_items), tr.mesh)

    return TrainRun(trainer, train_loader, val_loader, downstream)


def run_htm_tan(cfg, device, mesh=None):
    """TAN init / cotrain on HowTo100M features (reference train/main.py):
    ``--resume`` / ``--pretrain`` load a checkpoint before training;
    ``--test`` loads one and returns the HTM-Align results (or the
    validation loss when there is no ``htm_align.json``)."""
    run = build_htm_tan(cfg, device, mesh)
    trainer = run.trainer
    try:
        if cfg.resume:
            trainer.load_checkpoint(cfg.resume, mode="resume")
        elif cfg.pretrain:
            trainer.load_checkpoint(cfg.pretrain, mode="pretrain")
        if cfg.test:
            trainer.load_checkpoint(cfg.test, mode="test")
            res = (run.downstream(trainer) if run.downstream
                   else {"val_loss": trainer.evaluate(run.val_loader, 0)})
            if trainer.is_chief:
                print(res, flush=True)
            _summary(trainer)
            return res
        best = trainer.fit(run.train_loader, run.val_loader, downstream_eval=run.downstream)
        _summary(trainer)
        return best
    finally:
        run.close()


# ------------------------------------------------------------------ HTM-AA


def htm_aa_pairs(cfg) -> list:
    """The clip windows of ``{auto_align_tag}.csv`` under ``--data_root``
    (read without pandas): rows of videos whose ``htm_vlen.csv`` length
    is in (64, 2000) when that file exists (video_loader.py:70-73), each a
    ``num_frames / fps`` window centred on its timestamp, clamped at 0
    (video_loader.py:125-131)."""
    from exoground_tpu_torch.data.table import read_csv_records

    root = cfg.data_root
    rows = read_csv_records(os.path.join(root, f"{cfg.auto_align_tag}.csv"))
    vlen_path = os.path.join(root, "htm_vlen.csv")
    if os.path.exists(vlen_path):
        keep = {r["vid"] for r in read_csv_records(vlen_path) if 64 < r["vlen"] < 2000}
        rows = [r for r in rows if r["vid"] in keep]
    half = cfg.num_frames / cfg.fps / 2
    return [{"vid": r["vid"], "text": r["text"],
             "start": max(float(r["timestamp"]) - half, 0.0),
             "end": float(r["timestamp"]) + half} for r in rows]


def build_htm_e2e(cfg, device, mesh=None) -> TrainRun:
    """The tokenizer, the MIL-NCE checkpoint (``--convert_from_frozen_bn``
    renames a FrozenBN file's ``.scale`` to ``.weight``, main_nce.py:
    303-310), the clip reader and loader (sharded by host under ``mesh``),
    S3D-G (seeded by ``cfg.seed``; ``fc`` as wide as the text module's
    output) and the trainer, the trunk loaded unless ``--no-pt_backbone``."""
    from exoground_tpu_torch.data import ShardedSampler, ThreadedLoader
    from exoground_tpu_torch.data.video_clips import ClipConfig, HTMClipDataset
    from exoground_tpu_torch.models.s3d import S3D
    from exoground_tpu_torch.models.word2vec import Word2VecTokenizer
    from exoground_tpu_torch.train.trainer import S3DTrainer
    from exoground_tpu_torch.utils.convert import (
        convert_s3d_state_dict,
        convert_sentence_embedding_from_s3d,
        load_torch_checkpoint,
    )

    root = cfg.data_root
    tokenizer = Word2VecTokenizer.from_dict_file(os.path.join(root, "s3d_dict.npy"))
    ckpt = load_torch_checkpoint(os.path.join(root, "s3d_howto100m.pth"))
    if cfg.convert_from_frozen_bn:
        ckpt = {(k.replace(".scale", ".weight") if ".bn" in k else k): v
                for k, v in ckpt.items()}
    text_params = convert_sentence_embedding_from_s3d(ckpt)
    pairs = htm_aa_pairs(cfg)
    if not pairs:
        raise SystemExit(f"no HTM-AA pairs under {root}")
    train_ds = HTMClipDataset(ClipConfig(video_root=os.path.join(root, "videos"), fps=cfg.fps,
                                         num_frames=cfg.num_frames, seed=cfg.seed),
                              pairs, tokenizer)
    train_loader = ThreadedLoader(
        train_ds, cfg.batch_size,
        sampler=ShardedSampler(len(train_ds), seed=cfg.seed, **_hosts(mesh)),
        num_workers=cfg.num_workers)
    torch.manual_seed(cfg.seed)  # the model's initial weights
    model = S3D(num_classes=int(text_params["fc2.weight"].shape[0]), device=device)
    trainer = S3DTrainer(model, cfg, text_params, iters_per_epoch=len(train_loader),
                         device=device, mesh=mesh)
    if cfg.pt_backbone:
        trainer.load_backbone(convert_s3d_state_dict(ckpt))
    return TrainRun(trainer, train_loader, dataset=train_ds)


def run_htm_e2e(cfg, device, mesh=None):
    """The end-to-end S3D finetune (reference end2end/main_nce.py:275-403):
    ``--resume`` / ``--pretrain`` load a checkpoint, then ``fit``; the chief
    prints the clips ffmpeg decoded and those that came out grey, and the
    reader's ms a batch (its items' seconds over the batches read). Returns
    the last epoch's loss."""
    from exoground_tpu_torch.data.video_clips import ffmpeg_available

    run = build_htm_e2e(cfg, device, mesh)
    trainer, ds = run.trainer, run.dataset
    try:
        if cfg.resume:
            trainer.load_checkpoint(cfg.resume, mode="resume")
        elif cfg.pretrain:
            trainer.load_checkpoint(cfg.pretrain, mode="pretrain")
        last = trainer.fit(run.train_loader)
        if trainer.is_chief:
            batches = sum(s["steps"] for s in trainer.epoch_stats)
            print("clips " + json.dumps(dict(
                ffmpeg=ffmpeg_available(), decoded=ds.decoded, grey=ds.grey,
                reader_ms_a_batch=ds.item_s * 1e3 / max(batches, 1))), flush=True)
        _summary(trainer)
        return last
    finally:
        run.close()


if __name__ == "__main__":
    main()
