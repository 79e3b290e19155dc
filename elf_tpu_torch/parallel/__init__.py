from elf_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    param_shardings,
    make_sharded_train_step,
    replicate,
)
