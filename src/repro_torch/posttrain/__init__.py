"""Post-training of the port (``repro.posttrain``'s counterpart).

SFT datasets with prompt-loss masking (:mod:`.sft`), LoRA adapters as a
params-transform over any of the port's models (:mod:`.lora`), and DPO
preference tuning with on-policy sampling through the serve engine
(:mod:`.dpo`).  The ``sft`` and ``dpo`` run kinds in
:mod:`repro_torch.run.api` drive these through the shared gym loop.
"""
from .dpo import (DPOGym, PreferencePairDataset, make_dpo_step,
                  preference_synthetic_dataset, sample_onpolicy_pairs,
                  synthetic_preference_pairs)
from .lora import (ADAPTER_KEY, FrozenBaseOptimizer, LoRAConfig, LoRAModel,
                   export_merged, is_adapter_path, load_adapter, n_trainable,
                   save_adapter, zero_adapters)
from .sft import (PackedSFTDataset, load_sft_jsonl, sft_jsonl_dataset,
                  sft_synthetic_dataset, synthetic_sft_examples)

__all__ = [
    "ADAPTER_KEY", "DPOGym", "FrozenBaseOptimizer", "LoRAConfig",
    "LoRAModel", "PackedSFTDataset", "PreferencePairDataset",
    "export_merged", "is_adapter_path", "load_adapter", "load_sft_jsonl",
    "make_dpo_step", "n_trainable", "preference_synthetic_dataset",
    "sample_onpolicy_pairs", "save_adapter", "sft_jsonl_dataset",
    "sft_synthetic_dataset", "synthetic_preference_pairs",
    "synthetic_sft_examples", "zero_adapters",
]
