"""Data: the eval-set loaders, the training crop iterator and its threaded,
prefetched form."""

from tpucdc_torch.data.datasets import (EvalDataset, clic2020, eval_dataset,
                                        kodak, local_image_corpus,
                                        synthetic_images,
                                        synthetic_images_rich, tecnick,
                                        train_crop_iterator, training_corpus)
from tpucdc_torch.data.grain_pipeline import Prefetcher, grain_crop_iterator

__all__ = ["EvalDataset", "eval_dataset", "kodak", "clic2020", "tecnick",
           "local_image_corpus", "synthetic_images", "synthetic_images_rich",
           "training_corpus", "train_crop_iterator", "grain_crop_iterator",
           "Prefetcher"]
