"""Dataset/metadata registries (a copy of
``neuralsim_tpu/detector/catalog.py``, which imports no framework).

Capability parity with the reference's vendored detectron2 catalogs
(``optimization/utils/catalog.py``), whose one local modification — a
``remove()`` method on both catalogs — exists solely so the pipeline can
re-register ``train_dataset``/``val_dataset`` every outer iteration
(``neural_sim_main.py:758-764``). Same contract: named lazy dataset
loaders + per-name metadata singletons, with idempotent re-registration.
"""

from __future__ import annotations

from typing import Callable, Dict, List


class DatasetCatalog:
    """name -> zero-arg loader returning a list of dataset dicts."""

    def __init__(self):
        self._registry: Dict[str, Callable[[], List[dict]]] = {}

    def register(self, name: str, loader: Callable[[], List[dict]]):
        if name in self._registry:
            raise KeyError(f"dataset {name!r} already registered; remove() first")
        self._registry[name] = loader

    def get(self, name: str) -> List[dict]:
        return self._registry[name]()

    def list(self) -> List[str]:
        return sorted(self._registry)

    def remove(self, name: str):
        self._registry.pop(name, None)

    def clear(self):
        self._registry.clear()


class Metadata:
    """Attribute-style write-once metadata (detectron2 Metadata semantics:
    re-setting an attribute to a different value raises)."""

    def __init__(self, name: str):
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "_data", {})

    def __getattr__(self, key):
        try:
            return object.__getattribute__(self, "_data")[key]
        except KeyError:
            raise AttributeError(
                f"metadata {self.name!r} has no attribute {key!r}"
            ) from None

    def __setattr__(self, key, value):
        data = object.__getattribute__(self, "_data")
        if key in data and data[key] != value:
            raise AttributeError(
                f"metadata {self.name!r}.{key} already set to {data[key]!r}"
            )
        data[key] = value

    def set(self, **kwargs):
        for k, v in kwargs.items():
            setattr(self, k, v)
        return self

    def as_dict(self):
        return dict(object.__getattribute__(self, "_data"))


class MetadataCatalog:
    def __init__(self):
        self._registry: Dict[str, Metadata] = {}

    def get(self, name: str) -> Metadata:
        if name not in self._registry:
            self._registry[name] = Metadata(name)
        return self._registry[name]

    def list(self) -> List[str]:
        return sorted(self._registry)

    def remove(self, name: str):
        self._registry.pop(name, None)


# module-level singletons, mirroring detectron2's global catalogs
DATASET_CATALOG = DatasetCatalog()
METADATA_CATALOG = MetadataCatalog()


def register_coco_instances(name: str, metadata: dict, json_file: str,
                            image_root: str,
                            dataset_catalog: DatasetCatalog = DATASET_CATALOG,
                            metadata_catalog: MetadataCatalog = METADATA_CATALOG):
    """Register a COCO-format dataset (the reference calls detectron2's
    register_coco_instances each outer iteration after remove())."""
    import json
    import os

    def loader() -> List[dict]:
        with open(json_file) as f:
            doc = json.load(f)
        by_image: Dict[int, dict] = {}
        for img in doc["images"]:
            by_image[img["id"]] = {
                "file_name": os.path.join(image_root, img["file_name"]),
                "image_id": img["id"],
                "height": img["height"],
                "width": img["width"],
                "annotations": [],
            }
        for ann in doc.get("annotations", []):
            x, y, w, h = ann["bbox"]
            by_image[ann["image_id"]]["annotations"].append({
                "bbox": [x, y, x + w, y + h],  # XYXY internally
                "category_id": ann["category_id"],
                "iscrowd": ann.get("iscrowd", 0),
            })
        return [by_image[k] for k in sorted(by_image)]

    dataset_catalog.register(name, loader)
    md = metadata_catalog.get(name)
    with open(json_file) as f:
        cats = json.load(f).get("categories", [])
    md.set(json_file=json_file, image_root=image_root,
           thing_classes=[c["name"] for c in sorted(cats, key=lambda c: c["id"])],
           **metadata)
    return md
