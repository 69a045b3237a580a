"""The parallel layer on torch.distributed: a (data, space) mesh of
shards, frames sharded over ``data`` (:mod:`.batch`) and frame rows over
``space`` with the halo-exchange DWT (:mod:`.spatial`)."""
