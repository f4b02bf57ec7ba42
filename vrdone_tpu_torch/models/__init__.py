"""The MaskVRD relation model: backbone, FPN neck and query predictor."""
