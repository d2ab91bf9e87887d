"""Command line: ``python -m exoground_tpu_torch.train.main --dataset htm-370k
--model cotrain --data_root <tree>``.

Counterpart of ``exoground_tpu/train/main.py`` (``main`` :179, ``build_model``
:119, ``run_htm_tan`` :344-469) for the route this slice ports: TAN init or
cotrain on HowTo100M features, with the frozen word2vec tower inside the
step, a validation loss and the in-loop HTM-Align eval every
``--eval_freq`` epochs, and a checkpoint every epoch; ``--resume``,
``--pretrain`` and ``--test`` load them back.

The command line always takes the card (``main`` raises without one);
``main(argv, device="cpu")`` runs the plain path on the CPU, as the tests
do. Every other route raises ``NotImplementedError`` naming its ROADMAP
item (queue 1): EgoExo4D and LEMMA (item 7), HTM-AA / S3D (item 9), the
grounding, view-invariant and joint models (item 7), multi-host (item 4).

Expected --data_root layout (as the JAX route's):
  howto100m_s3d_features/*.mp4.npy         per-second video features
  sentencified_htm_<tag>.json              ASR sentences ({vid: {...}})
  htm_holdout_vid.txt, htm_vlen.csv        filters (optional)
  s3d_dict.npy + s3d_howto100m.pth         word2vec tokenizer + tower
  htm_align.json (optional)                in-loop HTM-Align eval
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Callable, Optional

import torch

_LATER = "a later slice of the port (ROADMAP.md, queue 1 item {})"
_MODEL_ITEMS = {"view_invariant": 7, "grounding": 7, "joint": 7, "s3d": 9}


def _check_model(cfg) -> None:
    if cfg.model not in ("init", "cotrain"):
        item = _MODEL_ITEMS.get(cfg.model, 7)
        raise NotImplementedError(f"--model {cfg.model} waits for {_LATER.format(item)}")


def build_model(cfg, video_dim: int, text_dim: int, device="cuda"):
    """The TAN model of ``cfg`` (init / cotrain): ``TemporalAligner`` with the
    JAX ``build_model``'s fields, its pre-projections sized by the data's
    video and text widths (the JAX Dense layers take them from the input)."""
    from exoground_tpu_torch.models import TemporalAligner

    _check_model(cfg)
    return TemporalAligner(
        num_encoder_layers=cfg.num_encoder_layers, num_joint_layers=cfg.num_decoder_layers,
        pos_enc=cfg.pos_enc, use_text_pos_enc=int(cfg.use_text_pos_enc),
        use_alignability_head=int(cfg.use_alignability_head),
        attn_impl=None if cfg.attn_impl == "auto" else cfg.attn_impl,
        video_dim=video_dim, text_dim=text_dim, device=device)


def main(argv=None, device="cuda"):
    """Parse ``argv`` and run its route on ``device``; returns what the
    route returns (the best score, or the ``--test`` results)."""
    from exoground_tpu_torch.train.config import parse_args, set_path
    from exoground_tpu_torch.utils.device import resolve_device

    cfg = parse_args(argv)
    dev = resolve_device(device)
    if cfg.multihost:
        raise NotImplementedError(f"--multihost waits for {_LATER.format(4)}")
    if cfg.dataset in ("egoexo4d", "lemma"):
        raise NotImplementedError(f"--dataset {cfg.dataset} waits for {_LATER.format(7)}")
    if cfg.dataset == "htm-aa":
        raise NotImplementedError(f"--dataset htm-aa waits for {_LATER.format(9)}")
    if not cfg.dataset.startswith("htm"):
        raise SystemExit(f"unknown --dataset {cfg.dataset}")
    _check_model(cfg)  # before set_path writes the experiment directory
    set_path(cfg)
    return run_htm_tan(cfg, dev)


@dataclass
class HTMTanRun:
    """What ``build_htm_tan`` builds from a configuration."""

    trainer: object
    train_loader: object
    val_loader: object
    downstream: Optional[Callable]

    def close(self):
        self.trainer.close()
        self.train_loader.close()
        self.val_loader.close()


def build_htm_tan(cfg, device) -> HTMTanRun:
    """The tokenizer and frozen tower from ``--data_root``, the train / val
    readers and loaders, the model (seeded by ``cfg.seed``), the trainer and
    the in-loop HTM-Align eval (when ``htm_align.json`` exists)."""
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
        train_ds, cfg.batch_size, sampler=ShardedSampler(len(train_ds), seed=cfg.seed),
        num_workers=cfg.num_workers)
    val_loader = ThreadedLoader(
        val_ds, cfg.batch_size, sampler=ShardedSampler(len(val_ds), shuffle=False),
        num_workers=cfg.num_workers, drop_last=False)

    video_dim = int(train_ds.store.read(train_ds.video_info[0], 0, 1).shape[-1])
    torch.manual_seed(cfg.seed)  # the model's initial weights
    model = build_model(cfg, video_dim, text_tower.out_dim, device=device)
    trainer = TANTrainer(model, cfg, iters_per_epoch=len(train_loader), device=device,
                         text_tower=text_tower)

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
            return evaluator_box["ev"](align_items)

    return HTMTanRun(trainer, train_loader, val_loader, downstream)


def run_htm_tan(cfg, device):
    """TAN init / cotrain on HowTo100M features (reference train/main.py):
    ``--resume`` / ``--pretrain`` load a checkpoint before training;
    ``--test`` loads one and returns the HTM-Align results (or the
    validation loss when there is no ``htm_align.json``)."""
    run = build_htm_tan(cfg, device)
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
            print(res, flush=True)
            return res
        return trainer.fit(run.train_loader, run.val_loader, downstream_eval=run.downstream)
    finally:
        run.close()


if __name__ == "__main__":
    main()
