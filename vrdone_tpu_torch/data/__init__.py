"""Host-side batch packing for the eval forward."""
