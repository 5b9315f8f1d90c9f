"""Default config tree.

Mirrors the reference's yacs schema (lib/config/default.py:17-178) key-for-key so the
reference's experiment YAMLs and ``KEY value`` CLI override lists work unchanged, plus the
``TPU`` section of the JAX package (buctd_tpu/config/defaults.py), kept key-for-key so
every experiment YAML loads in both packages.  The comment above the ``TPU`` section
says which of its keys the port reads.
"""

from __future__ import annotations

import os

from .node import CfgNode as CN


def default_config() -> CN:
    _C = CN()

    _C.OUTPUT_DIR = ""
    _C.LOG_DIR = ""
    _C.DATA_DIR = ""
    _C.GPUS = (0,)
    _C.WORKERS = 4
    _C.PRINT_FREQ = 20
    _C.AUTO_RESUME = False
    _C.PIN_MEMORY = True
    _C.RANK = 0
    _C.EPOCH_EVAL_FREQ = 10

    # kept for YAML compatibility with the reference; serving does not read them
    _C.CUDNN = CN()
    _C.CUDNN.BENCHMARK = True
    _C.CUDNN.DETERMINISTIC = False
    _C.CUDNN.ENABLED = True

    _C.MODEL = CN()
    _C.MODEL.NAME = "pose_hrnet"
    _C.MODEL.INIT_WEIGHTS = True
    _C.MODEL.PRETRAINED = ""
    _C.MODEL.NUM_JOINTS = 17
    _C.MODEL.TAG_PER_JOINT = True
    _C.MODEL.TARGET_TYPE = "gaussian"
    _C.MODEL.IMAGE_SIZE = [256, 256]  # width, height
    _C.MODEL.HEATMAP_SIZE = [64, 64]  # width, height
    _C.MODEL.SIGMA = 2
    _C.MODEL.EXTRA = CN(new_allowed=True)
    _C.MODEL.ATT_MODULES = [False, False, True, True]
    _C.MODEL.ATT_CHANNEL_ONLY = False
    _C.MODEL.ATTENTION_HEADS = 1
    _C.MODEL.SELFATT_MODULES = [False, False, False, False]
    _C.MODEL.CONDITIONAL_TOPDOWN = False

    # transformer (TransPose) keys
    _C.MODEL.DIM_MODEL = 96
    _C.MODEL.DIM_FEEDFORWARD = 192
    _C.MODEL.N_HEAD = 1
    _C.MODEL.ENCODER_LAYERS = 6
    _C.MODEL.ATTENTION_ACTIVATION = "relu"
    _C.MODEL.POS_EMBEDDING = "sine"

    _C.LOSS = CN()
    _C.LOSS.USE_OHKM = False
    _C.LOSS.TOPK = 8
    _C.LOSS.USE_TARGET_WEIGHT = True
    _C.LOSS.USE_DIFFERENT_JOINTS_WEIGHT = False

    _C.DATASET = CN()
    _C.DATASET.DATASET = "coco"
    _C.DATASET.ROOT = ""

    _C.DATASET.TRAIN_SET = "train"
    _C.DATASET.TRAIN_IMAGE_DIR = ""
    _C.DATASET.TRAIN_ANNOTATION_FILE = "train2017.json"

    _C.DATASET.TEST_SET = "valid"
    _C.DATASET.TEST_IMAGE_DIR = ""
    _C.DATASET.TEST_ANNOTATION_FILE = "val2017.json"

    _C.DATASET.COND_FILE = "full_pickle.pickle"

    _C.DATASET.SYNTHESIS_POSE = False
    _C.DATASET.SWAP_OVERLAP = 0.0

    _C.DATASET.DATA_FORMAT = "jpg"
    _C.DATASET.HYBRID_JOINTS_TYPE = ""
    _C.DATASET.SELECT_DATA = False

    _C.DATASET.SYNTHETIC_DATASET = "synthetic"
    _C.DATASET.SYNTHETIC_ROOT = ""
    _C.DATASET.SYNTHETIC_TRAIN_DATASET = "synthetic"
    _C.DATASET.SYNTHETIC_TRAIN_SET = "train"
    _C.DATASET.SYNTHETIC_TRAIN_IMAGE_DIR = ""
    _C.DATASET.SYNTHETIC_TRAIN_ANNOTATION_FILE = "train2017.json"
    _C.DATASET.SYNTHETIC_TRAIN_DATASET_TYPE = "coco_lambda_syn"
    _C.DATASET.SYNTHETIC_TEST_DATASET = "synthetic"
    _C.DATASET.SYNTHETIC_TEST_SET = "valid"
    _C.DATASET.SYNTHETIC_TEST_IMAGE_DIR = ""
    _C.DATASET.SYNTHETIC_TEST_ANNOTATION_FILE = "val2017.json"
    _C.DATASET.SYNTHETIC_TEST_DATASET_TYPE = "coco_lambda_syn"

    # training-time augmentation
    _C.DATASET.FLIP = True
    _C.DATASET.SCALE_FACTOR = 0.25
    _C.DATASET.ROT_FACTOR = 30
    _C.DATASET.PROB_HALF_BODY = 0.0
    _C.DATASET.NUM_JOINTS_HALF_BODY = 8
    _C.DATASET.COLOR_RGB = False
    _C.DATASET.BALANCED = False
    _C.DATASET.COLORED = False
    _C.DATASET.NEW_AUGMENTATION = True
    _C.DATASET.BBOX_AUGMENTATION = False
    _C.DATASET.STACKED_CONDITION = False
    _C.DATASET.BU_BBOX_MARGIN = 25
    _C.DATASET.USE_COND_FILTER = False

    _C.TRAIN = CN()
    _C.TRAIN.LR_FACTOR = 0.1
    _C.TRAIN.LR_STEP = [90, 110]
    _C.TRAIN.LR = 0.001
    _C.TRAIN.OPTIMIZER = "adam"
    _C.TRAIN.MOMENTUM = 0.9
    _C.TRAIN.WD = 0.0001
    _C.TRAIN.NESTEROV = False
    _C.TRAIN.GAMMA1 = 0.99
    _C.TRAIN.GAMMA2 = 0.0
    _C.TRAIN.BEGIN_EPOCH = 0
    _C.TRAIN.END_EPOCH = 140
    _C.TRAIN.RESUME = False
    _C.TRAIN.CHECKPOINT = ""
    _C.TRAIN.BATCH_SIZE_PER_GPU = 32
    _C.TRAIN.SHUFFLE = True
    _C.TRAIN.USE_BU_BBOX = True
    # cutmix/mixup double-target training (reference lib/core/train.py:179-343;
    # its MIPNet-era loops had no cfg keys — the mixed loader lived outside the
    # repo — so these knobs are ours): '' | 'cutmix' | 'mixup', Beta(α, α) draw.
    _C.TRAIN.MIX = ""
    _C.TRAIN.MIX_ALPHA = 1.0
    # gradient accumulation (ours): average k micro-batch grads into one
    # optimizer step (optax.MultiSteps) — effective batch = k x BATCH_SIZE_PER_GPU
    # x mesh size on memory-constrained chips.  LR milestones see optimizer steps.
    _C.TRAIN.GRAD_ACCUM_STEPS = 1

    _C.TEST = CN()
    _C.TEST.BATCH_SIZE_PER_GPU = 32
    _C.TEST.FLIP_TEST = False
    _C.TEST.POST_PROCESS = False
    _C.TEST.SHIFT_HEATMAP = False
    _C.TEST.USE_GT_BBOX = False
    _C.TEST.USE_BU_BBOX = True
    _C.TEST.IMAGE_THRE = 0.1
    _C.TEST.NMS_THRE = 0.6
    _C.TEST.SOFT_NMS = False
    _C.TEST.OKS_THRE = 0.5
    _C.TEST.IN_VIS_THRE = 0.0
    _C.TEST.COCO_BBOX_FILE = ""
    _C.TEST.BBOX_THRE = 1.0
    _C.TEST.MODEL_FILE = ""
    _C.TEST.BBOX_FRACTION = 1.0
    _C.TEST.DECAY_THRE = 0.5
    # run the legacy λ∈{0,1} sweep (validate_lambda_quantitative) instead of the
    # plain validate loop; ours only — the reference never plumbs it to a CLI
    _C.TEST.LAMBDA_SWEEP = False
    _C.TEST.SCALE_THRE = 1.25
    _C.TEST.USE_DARK = False
    _C.TEST.REFINE_ITERS = 1  # 3x iterative refinement as an in-process loop

    _C.DEBUG = CN()
    _C.DEBUG.DEBUG = False
    _C.DEBUG.SAVE_BATCH_IMAGES_GT = False
    _C.DEBUG.SAVE_BATCH_IMAGES_PRED = False
    _C.DEBUG.SAVE_HEATMAPS_GT = False
    _C.DEBUG.SAVE_HEATMAPS_PRED = False
    # per-IoU-bin pred dumps (reference vis.py:206-266, shipped commented out
    # there at :436-438; here an explicit opt-in flag)
    _C.DEBUG.SAVE_IOU_BIN_PRED = False

    _C.OUTPUT_JSON = None

    # --- the JAX package's TPU section, key for key ------------------------
    # Every experiment YAML carries it.  The port reads EVAL_DTYPE (float32
    # or bfloat16; tools/inference.py takes COMPUTE_DTYPE as JAX's tool
    # does), ATTENTION_ENGINE ('auto' = the hand-written
    # CUDA flash kernel (ops/flash_attention.py) for CUDA tensors with
    # L_q*L_k >= 512^2, batched matmuls elsewhere; 'flash'/'mapped' force),
    # COMPUTE_DTYPE, DEVICE_PIPELINE (False: the host cv2 Loader; True: the
    # device loader), WARP_ENGINE (auto/pallas: K4; matmul: torch.einsum),
    # PREFETCH, FUSED_PRENET, DEVICE_SYNTHESIS, REMAT, REMAT_MODE and
    # FUSED_OPTIMIZER, and MESH_SHAPE/MESH_AXES (parallel/mesh.py: the mesh
    # must match the run's cards, one a process).  The other keys belong to
    # paths not ported yet; buctd_tpu/config/defaults.py documents them.
    _C.TPU = CN()
    _C.TPU.MESH_SHAPE = [-1]
    _C.TPU.MESH_AXES = ["data"]
    _C.TPU.COMPUTE_DTYPE = "bfloat16"
    _C.TPU.EVAL_DTYPE = "float32"
    _C.TPU.PARAM_DTYPE = "float32"
    _C.TPU.DONATE_STATE = True
    _C.TPU.REMAT = False
    _C.TPU.REMAT_MODE = "modules"
    _C.TPU.DEVICE_PIPELINE = False
    _C.TPU.WARP_ENGINE = "auto"
    _C.TPU.DEVICE_SYNTHESIS = False
    _C.TPU.ATTENTION_ENGINE = "auto"
    _C.TPU.PREFETCH = 2
    _C.TPU.FUSED_PRENET = "off"
    _C.TPU.FUSED_OPTIMIZER = False

    return _C


def update_config(cfg: CN, args) -> None:
    """Merge YAML file + CLI opts, matching lib/config/default.py:180-207."""
    cfg.defrost()
    if getattr(args, "cfg", None):
        cfg.merge_from_file(args.cfg)
    cfg.merge_from_list(list(getattr(args, "opts", []) or []))

    if getattr(args, "modelDir", None):
        cfg.OUTPUT_DIR = args.modelDir
    if getattr(args, "logDir", None):
        cfg.LOG_DIR = args.logDir
    if getattr(args, "dataDir", None):
        cfg.DATA_DIR = args.dataDir

    cfg.DATASET.ROOT = os.path.join(cfg.DATA_DIR, cfg.DATASET.ROOT)
    cfg.MODEL.PRETRAINED = os.path.join(cfg.DATA_DIR, cfg.MODEL.PRETRAINED)
    if cfg.TEST.MODEL_FILE:
        cfg.TEST.MODEL_FILE = os.path.join(cfg.DATA_DIR, cfg.TEST.MODEL_FILE)
    cfg.freeze()
