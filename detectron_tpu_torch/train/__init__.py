"""Train state, checkpoints and the train driver.

Re-exports what ``detectron_tpu.train`` re-exports, but optax's and
flax's plumbing (``apply_gradients``: the SGD step is in ``train_step``;
``trainable_mask``: the trainable set is the parameters'
``requires_grad``)."""

from detectron_tpu_torch.train.state import (  # noqa: F401
    TrainState,
    create_train_state,
    make_optimizer,
    warmup_step_decay_schedule,
)
