"""Campaign engine: declarative experiment matrices over the renewal
Monte-Carlo engine, with a content-addressed resumable result store
(counterpart of ``repro.campaign``).

    spec     — axes / cartesian / zip / filter matrix composition and the
               normalized cell-config schema
    store    — content-addressed JSONL result store (resume = skip keys)
    runner   — chunked scan dispatch on a device + scatter back to cells
    analyze  — dataframe-free record aggregation and table emitters
    presets  — the canonical campaign definitions (CLI + benchmarks)

CLI: ``PYTHONPATH=src python -m repro_torch.campaign run --preset smoke
--store STORE --device cpu`` (the default device is cuda).
"""
from repro_torch.campaign.analyze import (           # noqa: F401
    get, group_by, label, markdown_table, pivot, select, summary_table,
    text_table,
)
from repro_torch.campaign.runner import (            # noqa: F401
    RunReport, run_campaign, summary_to_result,
)
from repro_torch.campaign.spec import (              # noqa: F401
    CampaignSpec, Matrix, ResolvedCell, axis, build_process, build_scenario,
    campaign, normalize_config, register_scenario, resolve, scenario_names,
)
from repro_torch.campaign.store import (             # noqa: F401
    ENGINE_VERSION, ResultStore, canonical_json, cell_key, diff_stores,
    is_store,
)
