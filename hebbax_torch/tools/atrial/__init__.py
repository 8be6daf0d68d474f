"""The Atrial (LA) volume tools: ``preprocess`` crops the raw cases,
``postprocess`` cleans predicted volumes."""
