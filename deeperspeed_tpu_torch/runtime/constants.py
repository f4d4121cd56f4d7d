"""Config key names + defaults (counterpart of
``deeperspeed_tpu/runtime/constants.py``, the same names and values)."""

TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"

OPTIMIZER = "optimizer"
SCHEDULER = "scheduler"
MAX_GRAD_NORM = "max_grad_norm"

FP16 = "fp16"
BFLOAT16 = "bf16"
ZERO_OPTIMIZATION = "zero_optimization"

GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0

PRESCALE_GRADIENTS = "prescale_gradients"
PRESCALE_GRADIENTS_DEFAULT = False

STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10

WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
WALL_CLOCK_BREAKDOWN_DEFAULT = False

DUMP_STATE = "dump_state"
DUMP_STATE_DEFAULT = False

SEED = "seed"
SEED_DEFAULT = 1234

# Routing of supported optimizer names (reference ``runtime/config.py`` +
# fork's mu-optimizers at ``runtime/engine.py:1336-1350``).
ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
FUSED_ADAM_OPTIMIZER = "fusedadam"
CPU_ADAM_OPTIMIZER = "cpuadam"
LAMB_OPTIMIZER = "lamb"
LION_OPTIMIZER = "lion"
FUSED_LION_OPTIMIZER = "fusedlion"
SGD_OPTIMIZER = "sgd"
MUADAM_OPTIMIZER = "muadam"
MUADAMW_OPTIMIZER = "muadamw"
MUSGD_OPTIMIZER = "musgd"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
ADAGRAD_OPTIMIZER = "adagrad"
DEEPSPEED_OPTIMIZERS = [
    ADAM_OPTIMIZER, ADAMW_OPTIMIZER, FUSED_ADAM_OPTIMIZER, CPU_ADAM_OPTIMIZER,
    LAMB_OPTIMIZER, LION_OPTIMIZER, FUSED_LION_OPTIMIZER, SGD_OPTIMIZER, MUADAM_OPTIMIZER,
    MUADAMW_OPTIMIZER, MUSGD_OPTIMIZER, ONEBIT_ADAM_OPTIMIZER, ADAGRAD_OPTIMIZER,
]

PIPE_REPLICATED = "ds_pipe_replicated"

ROUTE_TRAIN = "train"
ROUTE_EVAL = "eval"
ROUTE_PREDICT = "predict"
