"""Datasets: CSV-backed light dataset and the preprocessed instruct dataset.

The port's own copy of prot2text_tpu/data/dataset.py (numpy only, no JAX);
names and behaviour are kept so the two packages collate alike.


  * Prot2TextLightDataset — thin dataset over one split CSV, rows as dicts
    (reference dataset/dataloader_light.py:81-94).
  * Prot2TextInstructDataset — the reference's PyG dataset (dataset.py:74-472)
    rebuilt storage-first: each protein is one .npz record under
    {root}/processed containing the tokenized chat fields + the graph arrays
    (node features, edge_index, edge_type).  `download()` wgets AlphaFoldDB
    PDBs (gated: this image has zero egress); `process()` runs the native
    PDB→graph featurizer in a process pool; failures are logged and skipped,
    and `len` reflects the usable processed files
    (reference fault-tolerance behavior, dataset.py:229-237, :432-450).

Chat composition mirrors dataset.py:340-399: trim description to 512 tokens /
sequence to 1021 residues, Llama-3.1 chat template with the placeholder token
repeated len(seq)+2 times, sequence tokenized with special tokens, description
tokenized with eos appended and no bos.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .chat import (
    LLAMA3_PLACEHOLDER_TOKEN, SYSTEM_MESSAGE, TextTokenizer,
    llama3_chat_prompt, protein_user_message,
)
from .tokenization import ProteinTokenizer


class Prot2TextLightDataset:
    """CSV rows as dicts (columns: AlphaFoldDB, Full Name, taxon, sequence,
    function)."""

    def __init__(self, csv_path: str):
        import pandas as pd

        self.df = pd.read_csv(csv_path)

    def __len__(self) -> int:
        return len(self.df)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        return self.df.iloc[idx].to_dict()


ALPHAFOLD_URL = "https://alphafold.ebi.ac.uk/files/AF-{uid}-F1-model_v{v}.pdb"


@dataclasses.dataclass
class Prot2TextInstructDataset:
    root_dir: str
    csv_path: str
    sequence_tokenizer: ProteinTokenizer = dataclasses.field(
        default_factory=ProteinTokenizer)
    description_tokenizer: Optional[TextTokenizer] = None
    alphafold_version: int = 4
    skip_download: bool = False
    skip_reload: bool = False
    num_processes: Optional[int] = None
    ignore_graph_features: bool = False
    max_sequence_length: Optional[int] = 1021
    max_description_length: Optional[int] = 512
    system_message: str = SYSTEM_MESSAGE
    placeholder_token: str = LLAMA3_PLACEHOLDER_TOKEN

    def __post_init__(self):
        import pandas as pd

        self.uniprot_df = pd.read_csv(self.csv_path)
        os.makedirs(self.raw_dir, exist_ok=True)
        os.makedirs(self.processed_dir, exist_ok=True)
        if not self.skip_download:
            self.download()
        if not self.skip_reload:
            self.process()
        self.update_usable_file_names()

    # -- paths -------------------------------------------------------------
    @property
    def raw_dir(self) -> str:
        return os.path.join(self.root_dir, "raw")

    @property
    def processed_dir(self) -> str:
        return os.path.join(self.root_dir, "processed")

    def raw_path(self, uid: str) -> str:
        return os.path.join(
            self.raw_dir, f"AF-{uid}-F1-model_v{self.alphafold_version}.pdb")

    def processed_path(self, uid: str) -> str:
        return os.path.join(self.processed_dir, f"{uid}.npz")

    # -- stages ------------------------------------------------------------
    def download(self):
        """wget PDBs from AlphaFoldDB; failures logged, not fatal
        (dataset.py:209-237).  No-op per file already present."""
        import urllib.request

        for uid in self.uniprot_df["AlphaFoldDB"]:
            path = self.raw_path(uid)
            if os.path.exists(path):
                continue
            url = ALPHAFOLD_URL.format(uid=uid, v=self.alphafold_version)
            try:
                urllib.request.urlretrieve(url, path)
            except Exception as e:  # logged-not-fatal
                print(f"[download] failed {uid}: {e}", file=sys.stderr)
                if os.path.exists(path):
                    os.remove(path)

    def process(self):
        """PDB → graph + tokenized chat → one .npz per protein, in a process
        pool (dataset.py:257-275); per-file failures are skipped."""
        import multiprocessing as mp

        todo = [
            uid for uid in self.uniprot_df["AlphaFoldDB"]
            if os.path.exists(self.raw_path(uid))
            and not os.path.exists(self.processed_path(uid))
        ]
        if not todo:
            return
        n = self.num_processes or max(os.cpu_count() // 2, 1)
        if n > 1 and len(todo) > 1:
            with mp.Pool(n) as pool:
                pool.map(self._process_one_safe, todo)
        else:
            for uid in todo:
                self._process_one_safe(uid)

    def _process_one_safe(self, uid: str):
        try:
            self.process_one(uid)
        except Exception as e:
            print(f"[process] failed {uid}: {e}", file=sys.stderr)

    def process_one(self, uid: str):
        raise NotImplementedError(
            "PDB → graph featurization (data/pdb_graph.py) is not ported yet "
            "(ROADMAP.md §1 item 12); the chat fields it would store come "
            "from _compose_and_tokenize_chat")

    # -- chat composition (dataset.py:340-399) ------------------------------
    def _compose_and_tokenize_chat(self, uid: str) -> Dict[str, np.ndarray]:
        if self.description_tokenizer is None:
            raise ValueError("description_tokenizer required for process()")
        row = self.uniprot_df.loc[self.uniprot_df["AlphaFoldDB"] == uid]
        import pandas as pd

        sequence = row["sequence"].values[0]
        description = row["function"].values[0]
        fullname = row["Full Name"].values[0]
        taxon = row["taxon"].values[0]
        fullname = "unknown" if pd.isna(fullname) else fullname
        taxon = "unknown" if pd.isna(taxon) else taxon

        tok = self.description_tokenizer
        if self.max_description_length is not None:
            ids = tok.encode(description, add_special_tokens=False)
            if len(ids) > self.max_description_length:
                ids = ids[:self.max_description_length]
                description = tok.decode(ids, skip_special_tokens=False)
        if (self.max_sequence_length is not None
                and len(sequence) > self.max_sequence_length):
            sequence = sequence[:self.max_sequence_length]

        user = protein_user_message(
            fullname, taxon, len(sequence) + 2, self.placeholder_token,
            light_style=False)
        prompt_ids = tok.encode(
            llama3_chat_prompt(self.system_message, user),
            add_special_tokens=False)
        sequence_ids = self.sequence_tokenizer.encode(
            sequence, add_special_tokens=True)
        desc_ids = tok.encode(description, add_special_tokens=False)
        desc_ids = desc_ids + [tok.eos_token_id]
        return {
            "sequence_input_ids": np.asarray(sequence_ids, np.int32),
            "prompt_input_ids": np.asarray(prompt_ids, np.int32),
            "description_input_ids": np.asarray(desc_ids, np.int32),
        }

    # -- access ------------------------------------------------------------
    def update_usable_file_names(self):
        """len == count of usable processed files (dataset.py:432-450)."""
        have = set()
        if os.path.isdir(self.processed_dir):
            have = {f[:-4] for f in os.listdir(self.processed_dir)
                    if f.endswith(".npz")}
        self.usable_uids: List[str] = [
            uid for uid in self.uniprot_df["AlphaFoldDB"] if uid in have]

    def __len__(self) -> int:
        return len(self.usable_uids)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        uid = self.usable_uids[idx]
        data = dict(np.load(self.processed_path(uid), allow_pickle=False))
        record = {
            "name": uid,
            "sequence_input_ids": data["sequence_input_ids"],
            "prompt_input_ids": data["prompt_input_ids"],
            "description_input_ids": data["description_input_ids"],
        }
        if not self.ignore_graph_features:
            record.update({
                "x": data["x"],
                "edge_index": data["edge_index"],
                "edge_type": data["edge_type"],
            })
            # record fields persisted since round 2 (older caches lack them)
            for k in ("coords", "distance_matrix", "distance", "node_id"):
                if k in data:
                    record[k] = data[k]
        return record
