"""Sharding rules for the port's mesh (port of ``repro.sharding``)."""

from repro_torch.sharding.rules import (P, Rules, admission_spec,  # noqa: F401
                                        block_table_spec, cache_spec,
                                        current_rules, default_table,
                                        expert_axes, move_payload,
                                        param_spec,
                                        place_admission,
                                        place_block_tables,
                                        place_prefix_snapshot,
                                        place_serving_params,
                                        place_swap_payload, row_shards,
                                        serving_param_specs, shard_cache,
                                        take_block, tree_param_specs,
                                        use_rules)
