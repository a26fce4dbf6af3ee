"""Datasets (COCO, VOC, CityPersons, synthetic), transforms and the loader."""
